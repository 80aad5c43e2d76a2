#!/usr/bin/env python3
"""Where the PyTorch/CUDA port's time goes, on one CUDA card.

    python3 scripts/torch_profile.py [vb] [e2e] [mesh] [scan] [extract]

Run from the root of a checkout on a machine with a CUDA card. Five parts
(all of them when none is named):

1. vb: the VB engine alone (`vbx_batched`, kernel route, f32 and bf16
   streams) at chip_smoke.py's bench shape, B=256, T=1025, S=31, D=128:
   one warm run under torch.profiler, device time by kernel (self CUDA
   time summed per name) and the device busy share of the run's wall;
2. e2e: ark -> RTTM on chip_smoke.py's 64-recording synthetic corpus
   (`diarize_ark`, f32 kernel route), warm: the pipeline's own stage
   timings (host init pool, VB left after init) from its runlog, and the
   device busy share over the whole run from torch.profiler;
3. mesh: the EM at chip_smoke.py's mesh shape (its 4 AMI-length
   recordings padded to B=4, T=32768, S=8, D=128; kernel route, f32, 10
   iterations past convergence): `vbx_sharded` on a 1x4 mesh of cuda:0
   repeated and the solo `vbx_batched`, each under torch.profiler, with
   device time by kernel and launches per iteration;
4. scan: the [T, B, S] smoother API at the A/B tool's kernel-level inputs
   (scripts/torch_ab_fb_kernels.py: T=1025, B=256, S=31, seed 0): the
   three kernel wrappers (fb_scan_fused K3, fb_scan_fwd K4, fb_scan_bwd
   K5) and the two `fb_scan` routes, taking turns, each call timed as
   chip_smoke.py times a wrapper (CUDA events around the one call, the
   host clock around the call alone). The same loop then runs under
   torch.profiler; from its trace, per call: the device time of each
   walk kernel, the lead to the first device operation (host work before
   the first launch; timed from the start event's cudaEventRecord, or
   from the call's annotation where the trace names no such runtime
   call, which also counts the profiler's own work), the idle gaps
   between the call's device operations, the tail after the last one,
   and the device's busy total;
5. extract: the extraction path at chip_smoke.py phase 7's shapes (one
   5-minute synthetic recording, ResNet101 with its seeded weights, one
   batch of 128 full windows): device time by kernel of one float32 and
   one bfloat16 batch (`XVectorExtractor.embed_batch`, no mask, as
   extract_file runs a batch of full windows), of the float32 batch with
   two of its windows cut to tails of 10 and 77 frames (the masked
   route), and of one recording's fbank + CMVN (`dithered_features`),
   each warm under
   torch.profiler; then, in turns, CUDA-event medians of the batch with
   the model in NCHW and in channels_last memory format, with
   torch.backends.cudnn.benchmark off and on, each variant's embeddings
   held to the shipped float32 form's (cosine, max abs error / max).

Prints a summary, then one JSON object with every number as its last
line. The profiler's own cost inflates wall and host times; the unprofiled
numbers are the ones to quote, the profiled device durations are not
inflated.
"""

import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("vb", "e2e", "mesh", "scan", "extract")
SCAN_SHAPE = (1025, 256, 31)
SCAN_REPS = 25
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


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


def part_vb(out):
    import chip_smoke
    from vbx_tpu_torch.engine.vbhmm import vbx_batched

    args = chip_smoke.bench_vb_args()
    for fb_impl in ("pallas", "pallas_bf16"):
        kw = dict(chip_smoke.BENCH_VB_KW, fb_impl=fb_impl)
        res = vbx_batched(*args, **kw)                      # warm-up
        wall, kernels = _profile(lambda: vbx_batched(*args, **kw))
        out[f"vb_{fb_impl}"] = dict(_summary(wall, kernels),
                                    iters=int(res.n_iters.max()))


def part_e2e(out):
    import chip_smoke
    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.engine.pipeline import diarize_ark

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


def part_mesh(out):
    import torch

    import chip_smoke
    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.engine.vbhmm import vbx_batched
    from vbx_tpu_torch.parallel import make_mesh, vbx_sharded
    from vbx_tpu_torch.testing import write_corpus

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


def _scan_calls():
    """{name: fn} of the scan part: the A/B tool's kernel-level inputs."""
    import torch

    from vbx_tpu_torch.ops import fb_scan_kernel as fbs

    T, B, S = SCAN_SHAPE
    rng = np.random.default_rng(0)
    logp = rng.normal(size=(T, B, S)).astype(np.float32)
    w = torch.as_tensor(np.exp(logp - logp.max(-1, keepdims=True)),
                        device="cuda")
    valid = torch.ones((T, B), dtype=torch.float32, device="cuda")
    pi = rng.dirichlet(np.ones(S), size=B).astype(np.float32)
    col = torch.as_tensor(0.1 * pi + 1e-8, device="cuda")
    pinit = torch.as_tensor(pi + 1e-8, device="cuda")
    lp = 0.9
    return {"fb_scan_fwd": lambda: fbs.fb_scan_fwd(w, col, pinit, lp),
            "fb_scan_fused": lambda: fbs.fb_scan_fused(w, col, pinit, lp),
            "fb_scan_bwd": lambda: fbs.fb_scan_bwd(w, col, lp),
            "route_two_pass": lambda: fbs.fb_scan(w, valid, col, pinit, lp,
                                                  fused=False),
            "route_fused": lambda: fbs.fb_scan(w, valid, col, pinit, lp,
                                               fused=True)}


def _scan_loop(calls, annotate):
    """{name: {"window_ms": [...], "host_ms": [...]}}: SCAN_REPS turns of
    every call, each timed as chip_smoke.py's _cuda_ms times one call."""
    import torch
    from torch.profiler import record_function

    times = {name: {"window_ms": [], "host_ms": []} for name in calls}
    for _ in range(SCAN_REPS):
        for name, fn in calls.items():
            ctx = (record_function(f"call::{name}") if annotate
                   else contextlib.nullcontext())
            with ctx:
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                t0 = time.perf_counter()
                fn()
                t1 = time.perf_counter()
                e.record()
                e.synchronize()
            times[name]["window_ms"].append(s.elapsed_time(e))
            times[name]["host_ms"].append((t1 - t0) * 1e3)
    return times


def _trace_per_call(trace_path):
    """[(name, {...})] per annotated call of a chrome trace: its device
    operations, the lead from its first cudaEventRecord (the start event;
    the annotation's start where the runtime call is not traced) to its
    first device operation, the idle gaps between its device operations
    and their busy total, in us."""
    with open(trace_path) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    calls = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"][len("call::"):]) for e in evs
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("call::"))
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in evs if e.get("cat") in DEVICE_CATS)
    records = sorted(float(e["ts"]) for e in evs
                     if e.get("cat") == "cuda_runtime"
                     and e["name"] == "cudaEventRecord")
    rows = []
    for c0, c1, name in calls:
        ops = [d for d in device if c0 <= d[0] <= c1]
        if not ops:
            raise RuntimeError(f"no device operation traced in call {name}")
        rec = [r for r in records if c0 <= r <= c1]
        start = rec[0] if rec else c0
        gaps = sum(max(0.0, b[0] - a[1]) for a, b in zip(ops, ops[1:]))
        walks = {}
        for d0, d1, kname in ops:
            for k in ("fb_scan_fwd_kernel", "fb_scan_fused_kernel",
                      "fb_scan_bwd_kernel"):
                if k in kname:
                    walks[k] = walks.get(k, 0.0) + d1 - d0
        rows.append((name, {
            "n_device_ops": len(ops), "lead_us": ops[0][0] - start,
            "busy_us": sum(d1 - d0 for d0, d1, _ in ops), "gaps_us": gaps,
            "span_us": ops[-1][1] - ops[0][0], "walks_us": walks,
            "start_from_event_record": bool(rec)}))
    return rows


def part_scan(out):
    import torch
    from torch.profiler import ProfilerActivity, profile

    calls = _scan_calls()
    for fn in calls.values():                     # builds the kernels
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    plain = _scan_loop(calls, annotate=False)
    with tempfile.TemporaryDirectory() as work:
        trace = os.path.join(work, "scan_trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiled = _scan_loop(calls, annotate=True)
        prof.export_chrome_trace(trace)
        rows = _trace_per_call(trace)
    med = statistics.median
    res = {"shape_tbs": list(SCAN_SHAPE), "reps": SCAN_REPS}
    for name in calls:
        mine = [r for n, r in rows if n == name]
        if len(mine) != SCAN_REPS:
            raise RuntimeError(f"{len(mine)} traced calls of {name}, "
                               f"expected {SCAN_REPS}")
        walk_names = sorted({k for r in mine for k in r["walks_us"]})
        window = profiled[name]["window_ms"]
        res[name] = {
            "window_ms": med(plain[name]["window_ms"]),
            "window_ms_min_max": [min(plain[name]["window_ms"]),
                                  max(plain[name]["window_ms"])],
            "host_ms": med(plain[name]["host_ms"]),
            "profiled_window_ms": med(window),
            "profiled_host_ms": med(profiled[name]["host_ms"]),
            "device_busy_ms": med(r["busy_us"] for r in mine) / 1e3,
            "device_span_ms": med(r["span_us"] for r in mine) / 1e3,
            "lead_ms": med(r["lead_us"] for r in mine) / 1e3,
            "gaps_ms": med(r["gaps_us"] for r in mine) / 1e3,
            # the profiled window left after the lead and the span
            "tail_ms": med(w - (r["lead_us"] + r["span_us"]) / 1e3
                           for w, r in zip(window, mine)),
            "device_ops": med(r["n_device_ops"] for r in mine),
            "walks_ms": {k: med(r["walks_us"].get(k, 0.0) for r in mine)
                         / 1e3 for k in walk_names},
            "lead_from_event_record": all(r["start_from_event_record"]
                                          for r in mine)}
    out["scan"] = res


def part_extract(out):
    import torch

    import chip_smoke
    from vbx_tpu_torch.device import full_fp32_matmuls
    from vbx_tpu_torch.engine.extractor import XVectorExtractor
    from vbx_tpu_torch.models.resnet import resnet101
    from vbx_tpu_torch.testing import synth_audio

    fs = chip_smoke.EXTRACT_FS
    signal, vad = synth_audio(np.random.default_rng(13),
                              chip_smoke.EXTRACT_SECONDS[0], fs)
    torch.manual_seed(0)
    models = {"f32": resnet101(64, 256)}
    torch.nn.init.zeros_(models["f32"].embedding.bias)
    models["bf16"] = resnet101(64, 256, dtype=torch.bfloat16)
    models["bf16"].load_state_dict(models["f32"].state_dict())
    ex = {k: XVectorExtractor(m, fs, device="cuda")
          for k, m in models.items()}
    dithered = ex["f32"].dither(signal)
    with torch.inference_mode():
        feats = ex["f32"].dithered_features(dithered, vad)
    starts, _, _ = ex["f32"].windows(feats, "rec")
    B = chip_smoke.EXTRACT_BATCH
    st = torch.tensor(starts[:B], device="cuda")
    ln = torch.tensor([144] * (B - 2) + [10, 77], device="cuda")

    def batch(tag, lengths=None):
        with torch.inference_mode(), full_fp32_matmuls():
            return ex[tag].embed_batch(feats.stream, st, lengths)

    def features():
        with torch.inference_mode():
            ex["f32"].dithered_features(dithered, vad)

    for tag, fn in (("extract_f32_batch", lambda: batch("f32")),
                    ("extract_bf16_batch", lambda: batch("bf16")),
                    ("extract_f32_batch_with_tails",
                     lambda: batch("f32", ln)),
                    ("extract_fbank_cmvn", features)):
        fn()
        wall, kernels = _profile(fn)
        out[tag] = _summary(wall, kernels)

    ref = batch("f32").float()
    variants = {}
    saved = torch.backends.cudnn.benchmark
    try:
        for rep in range(2):
            for tag in ("f32", "bf16"):
                for fmt in (torch.contiguous_format, torch.channels_last):
                    models[tag].to(memory_format=fmt)
                    for bench in (False, True):
                        torch.backends.cudnn.benchmark = bench
                        layout = ("nhwc" if fmt is torch.channels_last
                                  else "nchw")
                        name = (f"{tag}_{layout}_bench_"
                                f"{'on' if bench else 'off'}")
                        got = batch(tag).float()
                        ms = chip_smoke._cuda_ms(lambda: batch(tag), n=10)
                        cos = torch.nn.functional.cosine_similarity(
                            got, ref, dim=1).min().item()
                        err = ((got - ref).abs().max()
                               / ref.abs().max()).item()
                        variants.setdefault(name, {"ms": [], "cos_min": cos,
                                                   "err": err})
                        variants[name]["ms"].append(ms)
                models[tag].to(memory_format=torch.contiguous_format)
    finally:
        torch.backends.cudnn.benchmark = saved
    out["extract_variants"] = variants


def main(argv=None) -> int:
    import torch

    parts = list(sys.argv[1:] if argv is None else argv) or list(PARTS)
    bad = [p for p in parts if p not in PARTS]
    if bad:
        print(f"torch_profile: unknown part(s) {bad}; choose from {PARTS}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke

    out = {"device": torch.cuda.get_device_name(0),
           "card": chip_smoke.card_line()}
    for part, fn in (("vb", part_vb), ("e2e", part_e2e), ("mesh", part_mesh),
                     ("scan", part_scan), ("extract", part_extract)):
        if part in parts:
            fn(out)

    print(f"card: {out['card']}")
    for part in ("vb_pallas", "vb_pallas_bf16", "e2e_pallas", "em_mesh_1x4",
                 "em_solo", "extract_f32_batch", "extract_bf16_batch",
                 "extract_f32_batch_with_tails", "extract_fbank_cmvn"):
        if part not in out:
            continue
        r = out[part]
        print(f"{part}: wall {r['wall_ms']:.1f} ms, device busy "
              f"{r['device_busy_ms']:.1f} ms ({r['device_busy_share']:.1%})")
        for row in r["top"][:8]:
            print(f"  {row['ms']:9.3f} ms {row['count']:6d}x "
                  f"{row['share_of_busy']:6.1%}  {row['kernel']}")
    if "scan" in out:
        for name, r in out["scan"].items():
            if not isinstance(r, dict):
                continue
            walks = ", ".join(f"{k} {v:.4f}" for k, v in
                              r["walks_ms"].items())
            print(f"scan {name}: window {r['window_ms']:.4f} ms (host "
                  f"{r['host_ms']:.4f}); profiled: lead {r['lead_ms']:.4f}, "
                  f"busy {r['device_busy_ms']:.4f} in "
                  f"{r['device_ops']:g} ops, gaps {r['gaps_ms']:.4f}, tail "
                  f"{r['tail_ms']:.4f}; {walks}")
    for name, r in out.get("extract_variants", {}).items():
        print(f"extract batch {name}: "
              f"{' / '.join(f'{ms:.3f}' for ms in r['ms'])} ms (median of "
              f"10, CUDA events, in turns); vs shipped f32 cosine >= "
              f"{r['cos_min']:.7f}, max abs error / max {r['err']:.3g}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
