"""Forward-only block-operator walk (K2): the CUDA kernel that replaces
vbx_tpu/ops/fb_pallas.py:_fwd_product_kernel_sb, its plain PyTorch twin,
and its launch counter.

The frame-sharded smoother (parallel.fb_blockwise) summarizes each shard's
frames as a transition-operator product. It splits the shard's Tb frames
into R segments of Ts = Tb / R frames and walks every segment r, recording
b and row i from its own initial message finit[r, b, i, :]:

    first frame of the segment:  a = w_0 * finit
    every later frame:           a = w_t * (lp * prev + col_b)
    c = sum_s a;  if c > 1e-37:  prev = a * (1 / c),  ls += log c
                  else (an all-zero w frame): prev and ls stay unchanged

returning the final normalized message fhat [R, B, S, S] and ls [R, B, S],
both float32. Padded frames must be all-zero w frames (skipped exactly).

w keeps the E-step's [B, Tb, S] layout (float32 or bfloat16): vbx_tpu
handed its kernel an S-fold lane-replicated copy ([Ts, S, R*B*S]) to fill
the TPU's 128-lane tiles; the CUDA kernel shares each frame among the S
rows of one (r, b) instead. It holds S <= S_MAX = 128, vbx_tpu's cap.

`fb_fwd_product_sb` launches the kernel (csrc/fb_fwd_product_sb.cu) for
CUDA tensors and runs `fb_fwd_product_sb_plain` only for CPU tensors; any
other device raises. A CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vbx_tpu_torch.ops import cuda_build

S_MAX = 128          # speakers per lane the kernel holds (vbx_tpu's cap)
_TINY = 1e-37
_IO_DTYPES = (torch.float32, torch.bfloat16)


def _check(w, col, finit):
    if w.dim() != 3 or finit.dim() != 4:
        raise ValueError(f"w must be [B, Tb, S] and finit [R, B, S, S], got "
                         f"{tuple(w.shape)} and {tuple(finit.shape)}")
    B, Tb, S = w.shape
    R = finit.shape[0]
    if min(B, Tb, S, R) < 1:
        raise ValueError(f"empty input: w {tuple(w.shape)}, R={R}")
    if S > S_MAX:
        raise ValueError(f"S={S} > {S_MAX}: the operator-product kernel "
                         f"holds at most {S_MAX} speakers")
    if Tb % R:
        raise ValueError(f"R={R} segments must divide the frame extent "
                         f"Tb={Tb}")
    if w.dtype not in _IO_DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    for name, x, shape in (("col", col, (B, S)),
                           ("finit", finit, (R, B, S, S))):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {list(shape)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != w.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {w.device}")


def _launcher():
    """The kernel's C entry point (csrc/fb_fwd_product_sb.cu), built and
    loaded at first use."""
    fn = cuda_build.library("fb_fwd_product_sb").fb_fwd_product_sb_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
    return fn


def fb_fwd_product_sb(w: torch.Tensor, col: torch.Tensor,
                      finit: torch.Tensor, loop_prob: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Operator-product walk over R = finit.shape[0] segments of w.

    w: [B, Tb, S] float32 or bfloat16; col: [B, S] float32; finit:
    [R, B, S, S] float32 (R divides Tb). Returns (fhat [R, B, S, S],
    ls [R, B, S]) float32. CUDA tensors launch the kernel; CPU tensors run
    fb_fwd_product_sb_plain.
    """
    _check(w, col, finit)
    if w.device.type == "cpu":
        return fb_fwd_product_sb_plain(w, col, finit, loop_prob)
    if w.device.type != "cuda":
        raise ValueError(f"fb_fwd_product_sb runs on cuda or cpu, not "
                         f"{w.device}")
    fn = _launcher()
    B, Tb, S = w.shape
    R = finit.shape[0]
    fhat = torch.empty_like(finit)
    ls = torch.empty((R, B, S), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = fn(w.data_ptr(), col.data_ptr(), finit.data_ptr(),
                float(loop_prob), R, B, Tb, S,
                int(w.dtype == torch.bfloat16), fhat.data_ptr(),
                ls.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fb_fwd_product_sb kernel launch failed: CUDA "
                           f"error {rc} (R={R}, B={B}, Tb={Tb}, S={S}, "
                           f"{w.dtype})")
    fb_fwd_product_sb.launches += 1
    return fhat, ls


fb_fwd_product_sb.launches = 0   # kernel launches since the caller reset it


def fb_fwd_product_sb_plain(w: torch.Tensor, col: torch.Tensor,
                            finit: torch.Tensor, loop_prob: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's walk: all R * B * S lanes
    advance together, frame by frame in float32, with the kernel's skip
    rule. The CUDA kernel sums a frame in another order, takes an
    approximate reciprocal and builds ls from the exponents and the
    mantissa products of the c's instead of one log per frame, so the two
    agree to a few 1e-7, not bit for bit. Used for CPU tensors and as the
    kernel's reference on the card."""
    B, Tb, S = w.shape
    R = finit.shape[0]
    f32 = torch.float32
    lp = torch.tensor(float(loop_prob), dtype=f32, device=w.device)
    tiny = torch.tensor(_TINY, dtype=f32, device=w.device)
    one = torch.ones((), dtype=f32, device=w.device)
    zero = torch.zeros((), dtype=f32, device=w.device)
    # segment r's frame t of lane b, broadcast over the rows i
    wseg = w.view(B, R, Tb // R, S).permute(1, 0, 2, 3)    # [R, B, Ts, S]
    colr = col[None, :, None, :]
    prev = finit.clone()
    ls = torch.zeros((R, B, S), dtype=f32, device=w.device)
    for t in range(Tb // R):
        w_t = wseg[:, :, t].to(f32)[:, :, None, :]         # [R, B, 1, S]
        a = w_t * prev if t == 0 else w_t * (lp * prev + colr)
        c = a.sum(-1, keepdim=True)
        live = c > tiny
        csafe = torch.where(live, c, one)
        prev = torch.where(live, a * (1.0 / csafe), prev)
        ls = ls + torch.where(live, torch.log(csafe), zero)[..., 0]
    return prev, ls
