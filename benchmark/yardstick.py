"""The benchmark's arithmetic: the card's peaks, the least time of kernel
K1, the operations of the VB EM products and of ResNet101, the union of
device-busy intervals and idle gaps.

Frozen copies: `HBM_BYTES_PER_S`, `F32_OPS_PER_S`, `k1_bound` and
`_bound` are scripts/kernel_bounds.py's. The union of intervals replaces
the summed durations of vbx_tpu_torch/utils/profiling.py:
parse_trace_executable_us and of scripts/torch_profile.py:_summary, which
count work on two streams twice.
"""

import math
from typing import Dict, Iterable, List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores


def k1_bound(B: int, T: int, S: int, esize: int) -> dict:
    """K1 _fused_kernel_sb: w [B, T, S] (esize bytes a value) in, ahat and
    bhat out in the same type, cfw [B, T] float32 out, col / pinit / binit
    [B, S] float32 in; ~12 float32 operations per (lane, frame, speaker)."""
    nbytes = 3 * B * T * S * esize + B * T * 4 + 3 * B * S * 4
    return _bound(nbytes, 12 * B * T * S)


def _bound(nbytes: int, ops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def vb_em_flops(B: int, T_pad: int, S_pad: int, D: int, iters: int) -> int:
    """The two products of an EM iteration (the M-step's gamma^T rho and
    the E-step's rho alpha^T), 2 B T S D operations each, over the padded
    shape the engine runs."""
    return 4 * B * T_pad * S_pad * D * iters


def resnet_flops(frames: int, feat_dim: int = 64, m: int = 32,
                 blocks: Sequence[int] = (3, 4, 23, 3),
                 embed: int = 256) -> int:
    """Multiply-add operations x 2 of one ResNet101 window of `frames`
    frames (VBx's ResNet: 3x3 stem at m channels, Bottleneck stages of
    m, 2m, 4m, 8m planes, expansion 4, strides 1/2/2/2 over [feat_dim,
    frames], statistics pooling, the embedding layer). Convolutions and
    the embedding only: BatchNorm, ReLU and the pooling are not counted."""
    h, w = feat_dim, frames
    flops = 2 * 9 * 1 * m * h * w                    # stem 3x3, 1 -> m
    cin = m
    for i, n in enumerate(blocks):
        planes = m * 2 ** i
        for j in range(n):
            stride = 2 if (i > 0 and j == 0) else 1
            ho, wo = math.ceil(h / stride), math.ceil(w / stride)
            flops += 2 * cin * planes * h * w        # 1x1 reduce
            flops += 2 * 9 * planes * planes * ho * wo   # 3x3 (strided)
            flops += 2 * planes * planes * 4 * ho * wo   # 1x1 expand
            if j == 0 and (stride != 1 or cin != planes * 4):
                flops += 2 * cin * planes * 4 * ho * wo  # downsample
            cin = planes * 4
            h, w = ho, wo
    flops += 2 * (cin * h * 2) * embed               # mean+std -> embed
    return flops


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [g for g in gaps if g[1] > g[0]]


def by_name_seconds(ops: Iterable[Tuple[float, float, str]]
                    ) -> Dict[str, float]:
    """Device seconds by operation name, from (start_us, end_us, name)."""
    out: Dict[str, float] = {}
    for s, e, n in ops:
        out[n] = out.get(n, 0.0) + (e - s) / 1e6
    return out
