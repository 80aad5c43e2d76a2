#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card this process sees.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Makes the cell's inputs from the seed, warms up, measures for `--seconds`
seconds (whole units of the cell's work, so the window closes at the end
of the unit in flight), checks the outputs against the plain reference,
and prints one JSON line last: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics; its per-layer metrics with
--trace 1), `device`, and with --trace 1 `breakdown`. Exits non-zero,
with no result, where there is no CUDA card, where the cell asks for more
cards than there are, or where a JAX package or vbx_tpu was loaded.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv=None, device: str = "cuda") -> int:
    """`device` other than 'cuda' skips the card check and runs the cell
    there (the CPU tests' rehearsal of a run)."""
    clock = harness.Clock()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.load_manifest(), args.workload, args.seed,
                        args.seconds, bool(args.trace))
    for k, v in harness.apply_host_env(cell).items():
        print(f"host_env {k}={v}", file=sys.stderr)
    need = int(cell.workload["chips"])
    if device == "cuda":
        have = harness.card_count()
        if have < need:
            print(f"need {need} CUDA card(s), found {have}: no result",
                  file=sys.stderr)
            return 2
    result, checks = harness.driver(cell).run(cell, clock, device=device)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded forbidden modules {bad}: no result", file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
