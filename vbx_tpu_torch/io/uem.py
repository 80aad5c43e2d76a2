"""NIST UEM (un-partitioned evaluation map) files: the scoring-region
side-input dscore accepts via -u (its gen_uem default is what
metrics.der computes when no UEM is given)."""

from __future__ import annotations

from typing import Dict, List, Tuple


def read_uem(path: str) -> Dict[str, List[Tuple[float, float]]]:
    """Parse `<recording> <channel> <onset> <offset>` lines; multiple lines
    per recording accumulate into a list of scoring intervals."""
    out: Dict[str, List[Tuple[float, float]]] = {}
    with open(path) as fp:
        for line in fp:
            line = line.strip()
            if not line or line.startswith(";;") or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                raise ValueError(f"bad UEM line: {line!r}")
            rec, _chan, on, off = parts[0], parts[1], float(parts[2]), \
                float(parts[3])
            out.setdefault(rec, []).append((on, off))
    return out


def write_uem(path_or_fd, uem: Dict[str, List[Tuple[float, float]]]) -> None:
    from vbx_tpu_torch.io.common import open_sink

    with open_sink(path_or_fd) as fp:
        for rec in sorted(uem):
            for on, off in uem[rec]:
                fp.write(f"{rec} 1 {on:.3f} {off:.3f}\n")
