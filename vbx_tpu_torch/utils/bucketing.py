"""Ragged-batch bucketing (copy of vbx_tpu.utils.bucketing).

Corpus recordings vary in length by orders of magnitude (T ~ 1e2..1e5
x-vectors). One global pad wastes device work, and one batch per length
gives up batching. Strategy: round each recording's (T, S) up to a
small set of power-of-two-ish bucket shapes and group same-bucket recordings
into batches capped by a total-frames budget — few batch shapes, bounded
padding waste (< 2x worst case, far less in practice).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple


T_QUANTUM = 256   # smallest frame bucket (bucket_shape's default quantum)


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def bucket_shape(t: int, s: int, t_quantum: int = T_QUANTUM,
                 s_quantum: int = 8) -> Tuple[int, int]:
    """Round T up to a power of two (floored at t_quantum), S to a multiple
    of s_quantum. Buckets are deliberately coarse — one per OCTAVE of T —
    so recordings of similar length share a batch (the JAX package picked
    this rule to bound its compile count; the port keeps it so both
    packages batch a corpus identically)."""
    t = max(t, 1)
    tq = t_quantum
    while tq < t:
        tq *= 2
    return tq, round_up(max(s, 1), s_quantum)


def chunk_cap(t_pad: int, max_batch_frames: int) -> int:
    """Recordings per device batch for a bucket of padded length t_pad
    under a total-frames budget — THE batching-policy cap; pad_to_buckets
    and the pipeline's streaming dispatcher both consume it."""
    return max(1, max_batch_frames // t_pad)


def pad_to_buckets(
    shapes: Sequence[Tuple[int, int]],
    max_batch_frames: int = 2_000_000,
    t_quantum: int = 256,
    s_quantum: int = 8,
) -> Iterator[Tuple[List[int], int, int]]:
    """Group recording indices by bucket shape.

    shapes: per-recording (T, S).
    Yields (indices, T_pad, S_pad) with len(indices) * T_pad <=
    max_batch_frames per batch (at least one recording per batch).
    """
    groups = {}
    for i, (t, s) in enumerate(shapes):
        key = bucket_shape(t, s, t_quantum, s_quantum)
        groups.setdefault(key, []).append(i)
    for (t_pad, s_pad), idxs in sorted(groups.items()):
        per_batch = chunk_cap(t_pad, max_batch_frames)
        for k in range(0, len(idxs), per_batch):
            yield idxs[k:k + per_batch], t_pad, s_pad
