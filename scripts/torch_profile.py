#!/usr/bin/env python3
"""Where the PyTorch/CUDA port's time goes, on one CUDA card.

    python3 scripts/torch_profile.py

Run from the root of a checkout on a machine with a CUDA card. Three parts:

1. the VB engine alone (`vbx_batched`, kernel route, f32 and bf16
   streams) at chip_smoke.py's bench shape, B=256, T=1025, S=31, D=128:
   one warm run under torch.profiler, device time by kernel (self CUDA
   time summed per name) and the device busy share of the run's wall;
2. ark -> RTTM on chip_smoke.py's 64-recording synthetic corpus
   (`diarize_ark`, f32 kernel route), warm: the pipeline's own stage
   timings (host init pool, VB left after init) from its runlog, and the
   device busy share over the whole run from torch.profiler;
3. the EM at chip_smoke.py's mesh shape (its 4 AMI-length recordings
   padded to B=4, T=32768, S=8, D=128; kernel route, f32, 10 iterations
   past convergence): `vbx_sharded` on a 1x4 mesh of cuda:0 repeated and
   the solo `vbx_batched`, each under torch.profiler, with device time by
   kernel and launches per iteration.

Prints a summary, then one JSON object with every number as its last
line. The profiler's own cost inflates wall times; chip_smoke.py's
unprofiled numbers are the ones to quote.
"""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise RuntimeError("torch.profiler event has no device time field")


def _profile(fn):
    """(wall seconds, {kernel name: (count, device us)}) of one fn() run
    under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = (evt.count, us)
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time")
    return wall, kernels


def _summary(wall, kernels, top=12):
    busy_us = sum(us for _, us in kernels.values())
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / wall,
            "top": [{"kernel": k[:90], "count": c, "ms": us / 1e3,
                     "share_of_busy": us / busy_us}
                    for k, (c, us) in rows[:top]]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.engine.pipeline import diarize_ark
    from vbx_tpu_torch.engine.vbhmm import vbx_batched
    from vbx_tpu_torch.parallel import make_mesh, vbx_sharded
    from vbx_tpu_torch.testing import write_corpus

    out = {"device": torch.cuda.get_device_name(0),
           "card": chip_smoke.card_line()}
    args = chip_smoke.bench_vb_args()
    for fb_impl in ("pallas", "pallas_bf16"):
        kw = dict(chip_smoke.BENCH_VB_KW, fb_impl=fb_impl)
        res = vbx_batched(*args, **kw)                      # warm-up
        wall, kernels = _profile(lambda: vbx_batched(*args, **kw))
        out[f"vb_{fb_impl}"] = dict(_summary(wall, kernels),
                                    iters=int(res.n_iters.max()))

    with tempfile.TemporaryDirectory() as work:
        corpus = chip_smoke.smoke_corpus(work)
        runlog = os.path.join(work, "runlog.jsonl")

        def run(tag):
            diarize_ark(corpus["ark"], corpus["segments"],
                        os.path.join(work, tag), get_preset("example"),
                        corpus["plda"], corpus["transform"], verbose=False,
                        fb_impl="pallas", device="cuda",
                        runlog_path=runlog)

        run("warm_up")
        wall, kernels = _profile(lambda: run("profiled"))
        with open(runlog) as f:
            stages = [json.loads(line) for line in f
                      if '"stages"' in line][-1]
        out["e2e_pallas"] = dict(
            _summary(wall, kernels), recordings=len(corpus["truth"]),
            init_pool_s=stages["init_s"], vb_after_init_s=stages["vb_s"],
            chunks_launched_during_init=stages["vb_chunks_overlapped"],
            buckets=stages["buckets"])

    with tempfile.TemporaryDirectory() as work:
        corpus = write_corpus(
            os.path.join(work, "long"), 11, chip_smoke.MESH_LENGTHS,
            [chip_smoke.MESH_SPEAKERS] * len(chip_smoke.MESH_LENGTHS))
        cfg = get_preset("example").replace(
            init=f"random_{chip_smoke.MESH_SPEAKERS}+VB")
        args = chip_smoke.mesh_vb_args(corpus, cfg)
    mesh = make_mesh(1, 4, devices=[torch.device("cuda", 0)] * 4)
    n_iters = 10
    kw = dict(loop_prob=cfg.vb.loop_prob, Fa=cfg.vb.Fa, Fb=cfg.vb.Fb,
              epsilon=float("-inf"), fb_impl="pallas", max_iters=n_iters)
    for name, fn in (
            ("em_mesh_1x4", lambda: vbx_sharded(mesh, *args, **kw)),
            ("em_solo", lambda: vbx_batched(*args, device="cuda", **kw))):
        fn()                                                 # warm-up
        wall, kernels = _profile(fn)
        out[name] = dict(
            _summary(wall, kernels), shape=list(args[2].shape), iters=n_iters,
            launches_per_iter=sum(c for c, _ in kernels.values()) / n_iters)

    for part in ("vb_pallas", "vb_pallas_bf16", "e2e_pallas", "em_mesh_1x4",
                 "em_solo"):
        r = out[part]
        print(f"{part}: wall {r['wall_ms']:.1f} ms, device busy "
              f"{r['device_busy_ms']:.1f} ms ({r['device_busy_share']:.1%})")
        for row in r["top"][:8]:
            print(f"  {row['ms']:9.3f} ms {row['count']:6d}x "
                  f"{row['share_of_busy']:6.1%}  {row['kernel']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
