#!/usr/bin/env python3
"""Corpus-preset engine A/B at AMI scale for the PyTorch/CUDA port (the
counterpart of scripts/ab_corpus_engine.py): the 18-meeting synthetic
corpus (~11 h) through the batched diarize_ark (AHC init with the 'auto'
walk and the batched pre-stage, bucketed batched VB) under the
ami_mixheadset preset, once for each forward-backward engine: None (the
preset's own, 'pallas_bf16' on a card), 'structured', 'pallas' and
'pallas_bf16'. Each row prints its wall seconds, the sorted EM
iterations, the label agreement (min / mean) and the DER (exact / 10 ms
rasterized, collar 0.25) against the reference, and bounds=OK|FAIL with
ab_corpus_engine.py's bars: every meeting >= 99% agreement (up to
renaming), corpus DER < 0.5 exact and at 10 ms.

    python3 scripts/torch_ab_corpus_engine.py [n_meetings]
        [--check-meetings K] [--frames LO HI] [--device {cuda,cpu}]

The reference. ab_corpus_engine.py holds each row to the frozen oracle
tests/data/ami_scale_ref_labels.npz, labels that VBx's own PLDA and
transform.h5 made (scripts/gen_ami_ref_labels.py). Those models are not in
the repository: this driver runs on vbx_tpu_torch.testing's synthetic
models (torch_ami_scale_bench.write_models), so the oracle's labels
cannot judge its rows. Instead:
- at 18 meetings of the default lengths the corpus's fingerprint (the ark
  bytes and the hyperparameters, gen_ami_ref_labels.py's recipe, copied
  here as corpus_fingerprint) must equal the oracle's: the corpus is the
  oracle's, byte for byte;
- every row is held to the CPU's structured engine run on the first K
  meetings (--check-meetings, default 2; make_corpus's first K meetings
  are the same draws), as torch_ami_scale_bench.py --check-meetings does.
  The agreement and DER columns are over those K meetings. The same K
  meetings then run once on the card, untimed, before the rows.
Holding the rows to the oracle's labels waits until VBx's models are in
the repository.

The structured row on a card is the port's plain smoother, a host loop
of launches a frame (ops/forward_backward.py:_scaled_fb): a batch of the
16384-frame bucket costs seconds an iteration, and the row minutes (it
still runs the whole corpus within a half-hour call on an H100).

Results go to stdout in ab_corpus_engine.py's row format, then one JSON
line naming the card; details to stderr. It exits non-zero if a row
fails its bounds or a meeting is not diarized. With no card and no
--device cpu it exits non-zero before any work.
"""

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

import torch_ab_common as common  # noqa: E402
import torch_ami_scale_bench as ami  # noqa: E402

ORACLE = os.path.join(os.path.dirname(HERE), "tests", "data",
                      "ami_scale_ref_labels.npz")
AGREEMENT_BAR = 0.99          # ab_corpus_engine.py:8
DER_BAR = 0.5                 # ab_corpus_engine.py:10
FB_IMPLS = (None, "structured", "pallas", "pallas_bf16")
DEFAULT_FRAMES = (8000, 11000)


def corpus_fingerprint(ark_path: str, hp: dict) -> str:
    """scripts/gen_ami_ref_labels.py's fingerprint: sha256 of the ark bytes
    and the sorted hyperparameters, first 32 hex digits."""
    h = hashlib.sha256()
    with open(ark_path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 20), b""):
            h.update(blk)
    h.update(repr(sorted(hp.items())).encode())
    return h.hexdigest()[:32]


def hyperparameters(cfg) -> dict:
    """The oracle's hyperparameters (gen_ami_ref_labels.py:main)."""
    return dict(Fa=cfg.vb.Fa, Fb=cfg.vb.Fb, loopP=cfg.vb.loop_prob,
                threshold=cfg.ahc.threshold,
                smoothing=cfg.ahc.init_smoothing)


def times_by_recording(seg_path: str) -> dict:
    from vbx_tpu_torch.io.segments import read_segments

    times = {}
    for _, rec, s, e in read_segments(seg_path):
        times.setdefault(rec, []).append((s, e))
    return {r: np.asarray(t) for r, t in times.items()}


def score_row(outs, ref, times) -> dict:
    """ab_corpus_engine.py's columns over the reference's meetings:
    agreement per meeting (up to renaming) and the corpus DER, exact and
    rasterized at 10 ms, collar 0.25, overlaps ignored."""
    from vbx_tpu_torch.io.rttm import merge_adjacent_labels
    from vbx_tpu_torch.metrics.der import Turn, score_corpus
    from vbx_tpu_torch.testing import frame_agreement

    agrees, ours, theirs = {}, {}, {}
    for rec in sorted(ref):
        agrees[rec] = frame_agreement(ref[rec], outs[rec].labels1st)
        ts = times[rec]
        for dst, lab in ((ours, outs[rec].labels1st), (theirs, ref[rec])):
            s, e, lv = merge_adjacent_labels(ts[:, 0], ts[:, 1], lab)
            dst[rec] = [Turn(a, b, str(v)) for a, b, v in zip(s, e, lv)]
    ders = [score_corpus(theirs, ours, collar=0.25, ignore_overlaps=True,
                         rasterize=ras)[1].der for ras in (None, 0.01)]
    ok = min(agrees.values()) >= AGREEMENT_BAR and max(ders) < DER_BAR
    return {"agreement": agrees, "der_exact": ders[0], "der_10ms": ders[1],
            "ok": ok}


def reference_labels(k: int, frames, cfg, device) -> dict:
    """The first k meetings written alone and diarized on the CPU's
    structured engine: {meeting: labels}. The same small corpus then runs
    once on `device` under the preset's engine, untimed, so that no row
    pays for loading the kernels' libraries and the card's handles."""
    with tempfile.TemporaryDirectory() as d:
        ami.make_corpus(d, n_meetings=k, frames=frames)
        ami.write_models(d)
        outs, el, _ = ami.run(d, cfg, "structured", "cpu")
        _, warm, _ = ami.run(d, cfg, None, device)
    common.log(f"reference: CPU structured run of {k} meeting(s) in "
               f"{el:.1f}s; warm-up on {device} {warm:.1f}s")
    return {m: o.labels1st for m, o in outs.items()}


def run_row(d, cfg, fb, device) -> tuple:
    """diarize_ark over `d`'s corpus with fb_impl=fb: (outputs, wall s,
    launches, failures). A meeting whose init or VB raised is a failure,
    not a skipped row."""
    import torch

    from vbx_tpu_torch.engine.pipeline import diarize_ark

    failures = {}
    common.reset_launches()
    t0 = time.perf_counter()
    outs = diarize_ark(f"{d}/c.ark", f"{d}/c.seg", f"{d}/rttm_{fb}", cfg,
                       f"{d}/plda", f"{d}/transform.h5", verbose=False,
                       fb_impl=fb, failures=failures, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return outs, time.perf_counter() - t0, common.read_launches(), failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_meetings", nargs="?", type=int, default=18)
    ap.add_argument("--check-meetings", type=int, default=2)
    ap.add_argument("--frames", type=int, nargs=2, default=DEFAULT_FRAMES,
                    metavar=("LO", "HI"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from vbx_tpu_torch.utils.devices import measured_on

    on = measured_on(args.device, "torch_ab_corpus_engine")
    if on is None:
        return 2
    import torch

    from vbx_tpu_torch.engine.pipeline import resolve_fb_impl

    cfg = ami.preset()
    frames = tuple(args.frames)
    k = min(args.check_meetings, args.n_meetings)
    if k < 1:
        ap.error("--check-meetings must be at least 1: the rows are held "
                 "to the reference's meetings")
    common.log(f"device: {on}  meetings={args.n_meetings}")
    ref = reference_labels(k, frames, cfg, args.device)
    rows, failed = [], []
    with tempfile.TemporaryDirectory() as d:
        n_x, _ = ami.make_corpus(d, args.n_meetings, frames=frames)
        ami.write_models(d)
        common.log(f"corpus: {n_x} x-vectors")
        fingerprint = None
        if args.n_meetings == 18 and frames == DEFAULT_FRAMES:
            fingerprint = corpus_fingerprint(f"{d}/c.ark",
                                             hyperparameters(cfg))
            frozen = str(np.load(ORACLE)["fingerprint"])
            if fingerprint != frozen:
                common.log(f"torch_ab_corpus_engine: FAILED: corpus "
                           f"fingerprint {fingerprint} != the oracle's "
                           f"{frozen}")
                return 1
            common.log(f"corpus fingerprint {fingerprint} equals the "
                       f"frozen oracle's")
        times = times_by_recording(f"{d}/c.seg")
        for fb in FB_IMPLS:
            engine = resolve_fb_impl(fb, cfg, torch.device(args.device)
                                     ) or "structured"
            outs, wall, launches, failures = run_row(d, cfg, fb,
                                                     args.device)
            sc = score_row(outs, ref, times)
            iters = sorted(o.n_iters for o in outs.values())
            ag = list(sc["agreement"].values())
            print(f"{str(fb):12s} wall={wall:6.1f}s  iters={iters}  "
                  f"agree(min/mean)={min(ag):.4f}/{np.mean(ag):.4f}  "
                  f"DER(exact/10ms)={sc['der_exact']:.3f}/"
                  f"{sc['der_10ms']:.3f}  "
                  f"bounds={'OK' if sc['ok'] else 'FAIL'}", flush=True)
            common.log(f"  {fb}: engine {engine}, launches {launches}")
            if failures or len(outs) != args.n_meetings:
                failed.append(f"{fb}: {len(outs)} of {args.n_meetings} "
                              f"meetings diarized, failures {failures}")
            if not sc["ok"]:
                failed.append(f"{fb}: bounds FAIL {sc}")
            rows.append({"fb_impl": fb, "engine": engine,
                         "meetings": len(outs), "wall_s": wall,
                         "iters": iters, "agree_min": min(ag),
                         "agree_mean": float(np.mean(ag)),
                         "der_exact": sc["der_exact"],
                         "der_10ms": sc["der_10ms"], "ok": sc["ok"],
                         "launches": launches})
    print(json.dumps({
        "driver": "ab_corpus_engine", "device": on,
        "meetings": args.n_meetings, "xvectors": n_x,
        "fingerprint": fingerprint,
        "reference": f"CPU structured run of the first {k} meetings",
        "rows": rows}), flush=True)
    if failed:
        common.log("torch_ab_corpus_engine: FAILED: " + "; ".join(failed))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
