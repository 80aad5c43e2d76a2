"""VAD label (.lab) reader: lines of `<start-s> <end-s> [label]`
(reference consumer: predict.py:143-144)."""

from __future__ import annotations

import numpy as np


def read_lab(path: str) -> np.ndarray:
    """Return (N, 2) float array of [start, end] speech intervals in seconds."""
    rows = []
    with open(path) as fp:
        for line in fp:
            parts = line.split()
            if len(parts) >= 2:
                rows.append((float(parts[0]), float(parts[1])))
    return np.array(rows, dtype=float).reshape(-1, 2)


def lab_to_sample_ranges(labs_s: np.ndarray, sample_rate: int) -> np.ndarray:
    """Convert second-based intervals to integer sample ranges, matching the
    reference's truncation semantics (predict.py:143-144: `(lab * sr).astype(int)`)."""
    return (labs_s * sample_rate).astype(int)
