"""Kaldi `segments` file I/O — per-x-vector timing info.

Each line: `<xvector-name> <recording> <start-s> <end-s>` (reference
consumer: diarization_lib.read_xvector_timing_dict:96-110; producer:
predict.py:192)."""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import numpy as np

from vbx_tpu_torch.io.common import open_sink


def read_segments(path: str) -> List[Tuple[str, str, float, float]]:
    out = []
    with open(path) as fp:
        for line in fp:
            parts = line.split()
            if not parts:
                continue
            name, rec, start, end = parts[:4]
            out.append((name, rec, float(start), float(end)))
    return out


def read_xvector_timing_dict(path: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """segs_dict[recording] = (array_of_xvector_names, array of [start, end]).

    Consecutive lines of one recording must be contiguous (same grouping
    contract as the reference, diarization_lib.py:108-110); lines of a
    recording that comes back later join its entry."""
    rows = read_segments(path)
    if not rows:
        return {}
    names, recs, starts, ends = zip(*rows)
    times = np.column_stack((starts, ends)).astype(float)
    spans: Dict[str, List[Tuple[int, int]]] = {}
    i = 0
    for rec, group in itertools.groupby(recs):
        j = i + sum(1 for _ in group)
        spans.setdefault(rec, []).append((i, j))
        i = j
    return {rec: (np.array([n for i, j in sp for n in names[i:j]],
                           dtype=object),
                  np.concatenate([times[i:j] for i, j in sp]))
            for rec, sp in spans.items()}


def write_segments(path_or_fd, rows) -> None:
    """Write (name, recording, start, end) rows."""

    with open_sink(path_or_fd) as fp:
        for name, rec, start, end in rows:
            # space-delimited format: whitespace inside a token would
            # silently shift every later field on read
            for label, tok in (("segment name", name), ("recording", rec)):
                if not tok or any(c.isspace() for c in str(tok)):
                    raise ValueError(
                        f"segments {label} must be non-empty with no "
                        f"whitespace, got {tok!r}")
            fp.write(f"{name} {rec} {start} {end}\n")
