"""Scoring CLI: dscore-equivalent diarization evaluation (the port's copy of
vbx_tpu.cli.score: a host program, the same flags and the same printed
text). Run it as `python -m vbx_tpu_torch.cli.score -r REF.rttm -s SYS.rttm`.

Interface parity with dscore/score.py as invoked by the reference recipes
(run_example.sh:40, AMI_run.sh:63-65): `-r/--ref` and `-s/--sys` RTTM
file(s) or glob(s), `--collar`, `--ignore_overlaps`; prints the same
column set (DER, JER, B3-Precision/Recall/F1, GKT in both directions,
conditional entropies, MI, NMI — README.md:53-56) per recording plus the
time-weighted OVERALL row. First-party implementation (metrics.der event
scoring + metrics.frame_metrics) — no Perl md-eval.
"""

from __future__ import annotations

import argparse
import glob as globmod
import sys
from typing import Dict, List

from vbx_tpu_torch.metrics.der import Turn, score_corpus
from vbx_tpu_torch.metrics.frame_metrics import frame_clustering_metrics


def _load_turns(paths: List[str]) -> Dict[str, List[Turn]]:
    from vbx_tpu_torch.io.rttm import read_rttm
    out: Dict[str, List[Turn]] = {}
    for pattern in paths:
        files = sorted(globmod.glob(pattern)) or [pattern]
        for path in files:
            for seg in read_rttm(path):
                out.setdefault(seg.recording, []).append(
                    Turn(seg.start, seg.start + seg.duration, seg.speaker))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vbx_tpu_torch.cli.score",
        description="diarization scoring (dscore-equivalent)")
    p.add_argument("-r", "--ref", required=True, nargs="+",
                   help="reference RTTM file(s)/glob(s)")
    p.add_argument("-s", "--sys", required=True, nargs="+",
                   help="system RTTM file(s)/glob(s)")
    p.add_argument("-u", "--uem", type=str, default=None,
                   help="NIST UEM file restricting the scoring regions "
                        "(default: per-recording min onset..max offset, "
                        "dscore's gen_uem behavior)")
    p.add_argument("--step", type=float, default=0.01,
                   help="frame step (s) for the clustering-metric columns "
                        "(dscore's --step; DER/JER are event-based and "
                        "unaffected)")
    p.add_argument("--collar", type=float, default=0.0)
    p.add_argument("--ignore_overlaps", action="store_true")
    p.add_argument("--rasterize", type=float, nargs="?", const=0.01,
                   default=None, metavar="STEP",
                   help="snap turn/UEM boundaries to a STEP-second grid "
                        "before DER/JER scoring (md-eval stores event "
                        "times at 10 ms; default STEP when the flag is "
                        "given: 0.01). Without it, scoring is exact on "
                        "the boundary events.")
    p.add_argument("--per-recording", action="store_true",
                   help="also print one row per recording")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    ref = _load_turns(args.ref)
    sys_ = _load_turns(args.sys)
    missing = sorted(set(ref) - set(sys_))
    for rec in missing:
        sys_.setdefault(rec, [])
    uems = None
    if args.uem:
        from vbx_tpu_torch.io.uem import read_uem
        uems = read_uem(args.uem)
        uncovered = sorted((set(ref) | set(sys_)) - set(uems))
        if uncovered:
            # dscore (the parity target) rejects recordings absent from an
            # explicit UEM; silently falling back to gen_uem extents for
            # them would mix two scoring protocols in one OVERALL row
            print(f"ERROR: {len(uncovered)} recording(s) missing from "
                  f"{args.uem}: " + " ".join(uncovered), file=sys.stderr)
            return 1
    per, total = score_corpus(ref, sys_, collar=args.collar,
                              ignore_overlaps=args.ignore_overlaps,
                              uems=uems, rasterize=args.rasterize)
    cm = frame_clustering_metrics(ref, sys_, step=args.step, uems=uems)

    cols = ["DER", "JER", "B3-Precision", "B3-Recall", "B3-F1",
            "GKT(ref, sys)", "GKT(sys, ref)", "H(ref|sys)", "H(sys|ref)",
            "MI", "NMI"]
    print("\t".join(["File"] + cols))
    if args.per_recording:
        for rec in sorted(per):
            r = per[rec]
            rcm = frame_clustering_metrics({rec: ref.get(rec, [])},
                                           {rec: sys_.get(rec, [])},
                                           step=args.step, uems=uems)
            print("\t".join(
                [rec, f"{r.der:.2f}", f"{r.jer:.2f}",
                 f"{rcm.get('b3_precision', 0):.2f}",
                 f"{rcm.get('b3_recall', 0):.2f}",
                 f"{rcm.get('b3_f1', 0):.2f}",
                 f"{rcm.get('gkt_ref_sys', 0):.2f}",
                 f"{rcm.get('gkt_sys_ref', 0):.2f}",
                 f"{rcm.get('h_ref_given_sys', 0):.2f}",
                 f"{rcm.get('h_sys_given_ref', 0):.2f}",
                 f"{rcm.get('mi', 0):.2f}", f"{rcm.get('nmi', 0):.2f}"]))
    print("\t".join(
        ["*** OVERALL ***",
         f"{total.der:.2f}", f"{total.jer:.2f}",
         f"{cm.get('b3_precision', 0):.2f}", f"{cm.get('b3_recall', 0):.2f}",
         f"{cm.get('b3_f1', 0):.2f}",
         f"{cm.get('gkt_ref_sys', 0):.2f}", f"{cm.get('gkt_sys_ref', 0):.2f}",
         f"{cm.get('h_ref_given_sys', 0):.2f}",
         f"{cm.get('h_sys_given_ref', 0):.2f}",
         f"{cm.get('mi', 0):.2f}", f"{cm.get('nmi', 0):.2f}"]))
    if missing:
        print(f"WARNING: {len(missing)} recording(s) missing from sys: "
              + " ".join(missing), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
