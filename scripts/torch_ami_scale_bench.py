#!/usr/bin/env python3
"""AMI-scale end-to-end pipeline benchmark of the PyTorch/CUDA port on
synthetic data (the counterpart of scripts/ami_scale_bench.py): 18
meetings of 8-11k x-vectors each (~11 h audio equivalent) through the
batched diarize_ark (AHC init, the 'auto' route's walk and the batched
pre-stage for every meeting of N >= 6144, bucketed batched VB on the
card) with the per-stage breakdown from the runlog 'stages' event.

    python3 scripts/torch_ami_scale_bench.py [--fb-impl IMPL]
        [--plateau-ulps X] [--n-meetings N] [--frames LO HI]
        [--check-meetings K] [--device {cuda,cpu}]

The corpus is make_corpus's (scripts/ami_scale_bench.py's generator,
byte-equal files); the PLDA and transform.h5 are vbx_tpu_torch.testing's
synthetic models drawn from the same seed (VBx's own models are not in
the repository), so the figures do not compare with a run on VBx's
models. Preset ami_mixheadset ('pallas_bf16', plateau_ulps 4).

--frames LO HI: the range of meeting lengths (default 8000 11000).
--check-meetings K: run the first K meetings again on the CPU's
structured engine (make_corpus's first K meetings are the same draws) and
exit non-zero unless every one of them agrees with this run on >= 99% of
frames, up to renaming (scripts/ab_corpus_engine.py's bar).

Results go to stdout in ami_scale_bench.py's lines, then one JSON line;
details to stderr. With no card and no --device cpu it exits non-zero.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

CHECK_AGREEMENT = 0.99       # scripts/ab_corpus_engine.py:8


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_corpus(d, n_meetings=18, seed=0, frames=(8000, 11000)):
    """scripts/ami_scale_bench.py's generator: `d`/c.ark and `d`/c.seg,
    byte-equal to its files at the same arguments. Returns (x-vector
    count, {meeting: true speaker index [T]})."""
    from vbx_tpu_torch.io.ark import write_vec_ark
    from vbx_tpu_torch.io.segments import write_segments

    rng = np.random.default_rng(seed)
    vecs, rows, truth = [], [], {}
    for r in range(n_meetings):
        T = int(rng.uniform(*frames))
        K = int(rng.integers(3, 6))
        centers = rng.standard_normal((K, 256)) * 0.35
        z = np.zeros(T, int)
        cur = 0
        for t in range(T):              # markov speaker turns
            if rng.random() < 0.01:
                cur = int(rng.integers(0, K))
            z[t] = cur
        x = centers[z] + 0.8 * rng.standard_normal((T, 256))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        name = f"mtg{r:02d}"
        truth[name] = z
        for i in range(T):
            vecs.append((f"{name}_{i:06d}", x[i].astype(np.float32)))
            rows.append((f"{name}_{i:06d}", name,
                         round(i * 0.24, 3), round(i * 0.24 + 1.44, 3)))
    write_vec_ark(f"{d}/c.ark", vecs)
    write_segments(f"{d}/c.seg", rows)
    return len(vecs), truth


def write_models(d, seed=0):
    """The synthetic PLDA and transform.h5 (vbx_tpu_torch.testing) in `d`;
    returns their paths."""
    from vbx_tpu_torch.testing import synth_models, write_plda, \
        write_transform

    plda, transform = synth_models(np.random.default_rng(seed))
    paths = (f"{d}/plda", f"{d}/transform.h5")
    write_plda(paths[0], *plda)
    write_transform(paths[1], *transform)
    return paths


def preset(plateau_ulps=None):
    from vbx_tpu_torch.config import get_preset

    cfg = get_preset("ami_mixheadset")
    if plateau_ulps is not None:
        # A/B the f32 plateau stop (PARITY.md deviation 3): 0 disables
        cfg = cfg.replace(vb=dataclasses.replace(cfg.vb,
                                                 plateau_ulps=plateau_ulps))
    return cfg


def run(d, cfg, fb_impl, device):
    """diarize_ark over `d`'s corpus and models, synchronized. Returns
    (outputs, wall seconds, the runlog's 'stages' event)."""
    import torch

    from vbx_tpu_torch.engine.pipeline import diarize_ark

    t0 = time.time()
    outs = diarize_ark(
        f"{d}/c.ark", f"{d}/c.seg", f"{d}/rttm", cfg, f"{d}/plda",
        f"{d}/transform.h5", verbose=False, runlog_path=f"{d}/log.jsonl",
        fb_impl=fb_impl, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    el = time.time() - t0
    stages = None
    with open(f"{d}/log.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("event") == "stages":
                stages = rec
    return outs, el, stages


def check_against_cpu(outs, k, frames, cfg):
    """The first k meetings again, written alone and run on the CPU's
    structured engine; {meeting: frame agreement with `outs`}."""
    from vbx_tpu_torch.testing import frame_agreement

    with tempfile.TemporaryDirectory() as d:
        make_corpus(d, n_meetings=k, frames=frames)
        write_models(d)
        ref, el, _ = run(d, cfg, "structured", "cpu")
    log(f"CPU structured run of {k} meeting(s): {el:.1f}s")
    return {m: frame_agreement(ref[m].labels1st, outs[m].labels1st)
            for m in sorted(ref)}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fb-impl", default=None,
                    help="engine (default: the preset's, 'pallas_bf16')")
    ap.add_argument("--plateau-ulps", type=float, default=None)
    ap.add_argument("--n-meetings", type=int, default=18)
    ap.add_argument("--frames", type=int, nargs=2, default=(8000, 11000),
                    metavar=("LO", "HI"))
    ap.add_argument("--check-meetings", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from vbx_tpu_torch.utils.devices import measured_on

    on = measured_on(args.device, "torch_ami_scale_bench")
    if on is None:
        return 2
    import torch

    from vbx_tpu_torch.engine.pipeline import resolve_fb_impl
    from vbx_tpu_torch.testing import frame_agreement

    cfg = preset(args.plateau_ulps)
    engine = resolve_fb_impl(args.fb_impl, cfg,
                             torch.device(args.device)) or "structured"
    log(f"device: {on}  engine: {engine}")
    print(f"plateau_ulps={cfg.vb.plateau_ulps}", flush=True)

    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        n, truth = make_corpus(d, args.n_meetings,
                               frames=tuple(args.frames))
        write_models(d)
        log(f"corpus written in {time.time() - t0:.1f}s")
        print(f"corpus: {n} x-vectors", flush=True)
        outs, el, stages = run(d, cfg, args.fb_impl, args.device)
    tot_frames = sum(len(o.labels1st) for o in outs.values())
    audio_h = tot_frames * 0.24 / 3600
    print(f"{len(outs)} meetings, {tot_frames} x-vectors "
          f"(~{audio_h:.1f} h audio): {el:.1f}s wall -> "
          f"{audio_h / (el / 3600):.0f}x realtime", flush=True)
    if stages is not None:
        print(f"stages: init={stages['init_s']}s vb={stages['vb_s']}s "
              f"buckets={stages['buckets']}", flush=True)
    spk = sorted(o.n_speakers for o in outs.values())
    iters = sorted(o.n_iters for o in outs.values())
    print(f"speakers: {spk}\niters: {iters}", flush=True)
    vs_truth = {m: frame_agreement(truth[m], outs[m].labels1st)
                for m in sorted(outs)}
    log(f"frame agreement with the generator's truth (information): "
        f"min {min(vs_truth.values()):.4f}, mean "
        f"{np.mean(list(vs_truth.values())):.4f}")
    check = None
    if args.check_meetings:
        check = check_against_cpu(outs, args.check_meetings,
                                  tuple(args.frames), cfg)
        print(f"check vs CPU structured: "
              + ", ".join(f"{m} {a:.4f}" for m, a in check.items()),
              flush=True)
    print(json.dumps({
        "driver": "ami_scale", "device": on, "fb_impl": engine,
        "plateau_ulps": cfg.vb.plateau_ulps, "meetings": len(outs),
        "xvectors": tot_frames, "audio_h": audio_h, "wall_s": el,
        "x_realtime": audio_h / (el / 3600), "stages": stages,
        "speakers": spk, "iters": iters, "truth_agreement": vs_truth,
        "check_vs_cpu": check}), flush=True)
    if len(outs) != args.n_meetings:
        log(f"torch_ami_scale_bench: FAILED: {len(outs)} of "
            f"{args.n_meetings} meetings diarized")
        return 1
    if check is not None and min(check.values()) < CHECK_AGREEMENT:
        log(f"torch_ami_scale_bench: FAILED: agreement with the CPU "
            f"structured run below {CHECK_AGREEMENT}: {check}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
