"""RTTM read/write.

Output format matches the reference writer byte-for-byte
(vbhmm.py:48-51): `SPEAKER <file> 1 <start:03f> <dur:03f> <NA> <NA>
<label+1> <NA> <NA>` — note the reference's `:03f` format spec means
min-width 3 with default 6-digit precision, and integer cluster labels are
written 1-based.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from vbx_tpu_torch.io.common import open_sink


@dataclasses.dataclass(frozen=True)
class RttmSegment:
    recording: str
    start: float
    duration: float
    speaker: str

    @property
    def end(self) -> float:
        return self.start + self.duration


def write_rttm(path_or_fd, recording: str, starts: Sequence[float],
               ends: Sequence[float], labels: Sequence[int]) -> None:
    """Write merged, integer-labeled segments for one recording."""

    with open_sink(path_or_fd) as fp:
        for label, s, e in zip(labels, starts, ends):
            fp.write(f"SPEAKER {recording} 1 {s:03f} {e - s:03f} "
                     f"<NA> <NA> {int(label) + 1} <NA> <NA>{os.linesep}")


def write_rttm_str(path_or_fd, segments: Iterable[RttmSegment]) -> None:
    """Write arbitrary (string-labeled) RTTM segments."""

    with open_sink(path_or_fd) as fp:
        for seg in segments:
            fp.write(f"SPEAKER {seg.recording} 1 {seg.start:03f} "
                     f"{seg.duration:03f} <NA> <NA> {seg.speaker} "
                     f"<NA> <NA>{os.linesep}")


def read_rttm(path: str) -> List[RttmSegment]:
    """Parse SPEAKER lines of an RTTM file."""
    out: List[RttmSegment] = []
    with open(path) as fp:
        for line in fp:
            parts = line.split()
            if not parts or parts[0].upper() != "SPEAKER":
                continue
            if len(parts) < 8:
                raise ValueError(
                    f"{path}: malformed RTTM SPEAKER line "
                    f"({len(parts)} fields < 8): {line.rstrip()!r}")
            out.append(RttmSegment(
                recording=parts[1],
                start=float(parts[3]),
                duration=float(parts[4]),
                speaker=parts[7],
            ))
    return out


def rttm_by_recording(segs: Iterable[RttmSegment]) -> Dict[str, List[RttmSegment]]:
    out: Dict[str, List[RttmSegment]] = {}
    for s in segs:
        out.setdefault(s.recording, []).append(s)
    return out


def merge_adjacent_labels(
    starts: np.ndarray, ends: np.ndarray, labels: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compact labeled segments: merge adjacent/overlapping same-label
    segments; split the boundary of overlapping different-label segments at
    the middle of the overlap (reference semantics: diarization_lib.py:113-135,
    reproduced by tests/test_io.py's parity battery — the implementation
    below is an original run-building formulation, not the reference's).

    Two semantic subtleties the parity tests pin down: a run takes the end
    time of its LAST member even if an earlier member extended further, and
    "adjacent" tolerates float noise via isclose().
    """
    starts = np.asarray(starts, dtype=float)
    ends = np.asarray(ends, dtype=float)
    labels = np.asarray(labels)
    n = len(starts)
    if n == 0:
        return starts, ends, labels

    # pass 1: group consecutive segments into runs — a segment continues
    # the current run iff it carries the same label and touches (or
    # overlaps) its immediate predecessor
    first = [0]                  # index of each run's first segment
    last: List[int] = []         # index of each run's last segment
    for i in range(1, n):
        same_run = labels[i] == labels[i - 1] and (
            starts[i] < ends[i - 1] or np.isclose(ends[i - 1], starts[i]))
        if not same_run:
            last.append(i - 1)
            first.append(i)
    last.append(n - 1)

    out_starts = starts[first]
    out_ends = ends[last]
    out_labels = labels[first]

    # pass 2: neighbouring runs with DIFFERENT labels may still overlap —
    # their shared boundary meets in the middle of the overlap. Each
    # boundary touches a disjoint (end, start) pair, so in-place is safe.
    for j in range(1, len(first)):
        if out_starts[j] < out_ends[j - 1]:
            mid = (out_ends[j - 1] + out_starts[j]) / 2.0
            out_ends[j - 1] = mid
            out_starts[j] = mid
    return out_starts, out_ends, out_labels


def segment_to_frame_labels(
    starts: np.ndarray, ends: np.ndarray, labels: np.ndarray,
    length: int = 0, frame_rate: float = 100.0, empty_label=None,
) -> np.ndarray:
    """Expand labeled segments into per-frame labels at `frame_rate`
    (reference semantics: diarization_lib.py:138-159). `length>0` truncates or
    pads to exactly `length`; `length<0` only pads up to `-length`."""
    min_len, max_len = (length, length) if length > 0 else (-length, None)
    starts = np.rint(frame_rate * np.asarray(starts, dtype=float)).astype(int)
    ends = np.rint(frame_rate * np.asarray(ends, dtype=float)).astype(int)
    labels = np.asarray(labels)
    if not ends.size:
        return np.full(min_len, empty_label)

    vals: List = []
    reps: List[int] = []
    prev_end = 0
    for s, e, lab in zip(starts, ends, labels):
        vals += [empty_label, lab]
        reps += [s - prev_end, e - s]
        prev_end = e
    vals.append(empty_label)
    reps.append(max(0, min_len - prev_end))
    frms = np.repeat(np.array(vals, dtype=object), np.array(reps))
    return frms[:max_len]
