"""Diarization CLI of the PyTorch/CUDA port: x-vector ark + segments +
PLDA -> per-recording RTTMs.

The same flags as vbx_tpu.cli.diarize (argument parity with the reference
CLI VBx/vbhmm.py:54-102, plus --init random_<N>[+VB], --preset and
--no-batch), plus --device (default cuda; 'cpu' runs the port on the host
explicitly). --mesh DPxSP builds the ('dp', 'sp') mesh of the sharded
engine on --device: the visible cards, or CPU copies with --device cpu.
Run it as `python -m vbx_tpu_torch.cli.diarize ...`.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from vbx_tpu_torch.config import DATASET_PRESETS, DiarizationConfig, get_preset
from vbx_tpu_torch.engine.pipeline import diarize_ark
from vbx_tpu_torch.parallel.mesh import parse_mesh_arg
from vbx_tpu_torch.utils.profiling import trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vbx_tpu_torch.cli.diarize",
        description="VB-HMM x-vector diarization (PyTorch/CUDA port)")
    p.add_argument("--init", required=True, type=str,
                   help="AHC, AHC+VB, random_<N>, or random_<N>+VB")
    p.add_argument("--out-rttm-dir", required=True, type=str)
    p.add_argument("--xvec-ark-file", required=True, type=str)
    p.add_argument("--segments-file", required=True, type=str)
    p.add_argument("--xvec-transform", required=True, type=str)
    p.add_argument("--plda-file", required=True, type=str)
    p.add_argument("--threshold", type=float, default=None,
                   help="bias added to the AHC calibration threshold")
    p.add_argument("--lda-dim", type=int, default=None)
    p.add_argument("--Fa", type=float, default=None)
    p.add_argument("--Fb", type=float, default=None)
    p.add_argument("--loopP", type=float, default=None)
    p.add_argument("--target-energy", type=float, default=None,
                   help="PLDA-scoring PCA energy (default: preset's value, "
                        "1.0 like the reference vbhmm.py:85-89)")
    p.add_argument("--init-smoothing", type=float, default=None)
    p.add_argument("--output-2nd", action="store_true", default=False)
    p.add_argument("--preset", type=str, default=None,
                   help="dataset preset name "
                        f"({sorted(DATASET_PRESETS)}) or a .yaml/.yml/.json "
                        "config file, supplying defaults for "
                        "threshold/lda-dim/Fa/Fb/loopP/smoothing")
    p.add_argument("--no-batch", action="store_true",
                   help="run recordings one by one (streaming) instead of "
                        "the padded-batched engine")
    p.add_argument("--max-batch-frames", type=int, default=2_000_000)
    p.add_argument("--fb-impl", type=str, default=None,
                   choices=["structured", "assoc", "pallas", "pallas_bf16"],
                   help="forward-backward engine (default: structured; "
                        "'pallas' = the fused CUDA kernel route, "
                        "'pallas_bf16' = the same kernel with bfloat16 "
                        "streams (tolerance-parity); 'assoc' is not "
                        "ported yet)")
    p.add_argument("--ahc-fallback-n", type=int, default=None,
                   help="recordings with more x-vectors than this skip "
                        "AHC for random_<K> init (the reference README's "
                        "long-file advice; measured crossover ~30k — "
                        "BENCHMARKS.md). 0 disables.")
    p.add_argument("--ahc-fallback-speakers", type=int, default=None,
                   help="K for the long-recording random_<K> fallback "
                        "(default: preset's value, 16)")
    p.add_argument("--mesh", type=str, default=None, metavar="DPxSP",
                   help="route VB through the sharded engine over a "
                        "('dp','sp') device mesh, e.g. 4x2: recordings "
                        "data-parallel, frames sequence-parallel — the "
                        "long-recording path (hour-plus meetings spread "
                        "their frames over the 'sp' devices). Built on "
                        "--device: the visible cards, or CPU copies with "
                        "--device cpu. Overrides --fb-impl.")
    p.add_argument("--plateau-ulps", type=float, default=None,
                   help="opt-in f32 plateau stop: freeze a recording whose "
                        "|dELBO| stays within this many machine quanta of "
                        "|ELBO| for --plateau-iters consecutive iterations "
                        "(stops one quantum-cycling recording from running "
                        "a whole padded batch to max-iters). 0 = off; "
                        "default: preset's value (corpus presets use 4.0)")
    p.add_argument("--plateau-iters", type=int, default=None,
                   help="consecutive small deltas before the plateau stop "
                        "fires (default: preset's value, 2)")
    p.add_argument("--resume", action="store_true",
                   help="skip recordings whose RTTM already exists "
                        "(per-recording checkpointing)")
    p.add_argument("--runlog", type=str, default=None,
                   help="append per-recording JSON records to this file")
    p.add_argument("--device", type=str, default="cuda",
                   help="device for the VB engine (default cuda; with no "
                        "CUDA card pass 'cpu' explicitly)")
    return p


def config_from_args(args) -> DiarizationConfig:
    cfg = get_preset(args.preset) if args.preset else get_preset("example")
    vb = cfg.vb
    ahc = cfg.ahc
    if args.Fa is not None or args.Fb is not None or args.loopP is not None:
        vb = dataclasses.replace(
            vb,
            Fa=args.Fa if args.Fa is not None else vb.Fa,
            Fb=args.Fb if args.Fb is not None else vb.Fb,
            loop_prob=args.loopP if args.loopP is not None else vb.loop_prob)
    if args.threshold is not None or args.init_smoothing is not None:
        ahc = dataclasses.replace(
            ahc,
            threshold=(args.threshold if args.threshold is not None
                       else ahc.threshold),
            init_smoothing=(args.init_smoothing
                            if args.init_smoothing is not None
                            else ahc.init_smoothing))
    if args.target_energy is not None:
        ahc = dataclasses.replace(ahc, target_energy=args.target_energy)
    # getattr: config_from_args is shared with other CLI parsers (serve);
    # a flag existing on one parser must not crash another
    if getattr(args, "ahc_fallback_n", None) is not None:
        ahc = dataclasses.replace(ahc, fallback_n=args.ahc_fallback_n)
    if getattr(args, "ahc_fallback_speakers", None) is not None:
        ahc = dataclasses.replace(
            ahc, fallback_speakers=args.ahc_fallback_speakers)
    if getattr(args, "plateau_ulps", None) is not None:
        vb = dataclasses.replace(vb, plateau_ulps=args.plateau_ulps)
    if getattr(args, "plateau_iters", None) is not None:
        vb = dataclasses.replace(vb, plateau_iters=args.plateau_iters)
    if not 0 <= vb.loop_prob <= 1:
        raise SystemExit(f"Expecting loopP between 0 and 1, got "
                         f"{vb.loop_prob} instead.")
    return cfg.replace(
        init=args.init, vb=vb, ahc=ahc,
        lda_dim=args.lda_dim if args.lda_dim is not None else cfg.lda_dim,
        output_2nd=args.output_2nd)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    mesh = parse_mesh_arg(args.mesh, device=args.device)
    failures = {}
    with trace():   # torch.profiler capture iff VBX_TPU_TRACE_DIR is set
        outputs = diarize_ark(
            args.xvec_ark_file, args.segments_file, args.out_rttm_dir, cfg,
            args.plda_file, args.xvec_transform,
            batch=not args.no_batch, max_batch_frames=args.max_batch_frames,
            resume=args.resume, runlog_path=args.runlog,
            fb_impl=args.fb_impl, failures=failures, device=args.device,
            mesh=mesh)
    for rec, out in outputs.items():
        print(f"{rec}: {out.n_speakers} speakers, {out.n_iters} VB "
              f"iterations", file=sys.stderr)
    if failures:
        print(f"{len(failures)} recording(s) FAILED: "
              f"{', '.join(sorted(failures))}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
