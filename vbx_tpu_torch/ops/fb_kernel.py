"""Fused bidirectional scaled forward-backward walk: the CUDA kernel that
replaces vbx_tpu/ops/fb_pallas.py:_fused_kernel_sb, its plain PyTorch twin,
and the engine-facing wrapper fb_scan_sb_logp_bts.

What is computed, per recording lane, in one sequential walk (see
ops.forward_backward for the derivation):

    forward:  a_t = w_t * (lp * ahat_{t-1} + col),  a_0 = w_0 * pinit,
              c_t = max(sum_s a_t, 1e-37),          ahat_t = a_t / c_t
    backward: u = w_{t+1} * bhat_{t+1},  b_t = lp * u + sum_s(col * u),
              bhat_t = b_t / sum_s b_t,  bhat_{T-1} = binit

Outputs ahat and bhat carry the stream type (float32 or bfloat16) and c_t
is float32; all arithmetic is float32. `recip` normalizes by multiplying
with the reciprocal; `skip_dead` makes an all-zero w frame an exact no-op
(carry kept, c = 1), which the frame-sharded path will need for boundary
messages. Padded frames of the single-recording path are a uniform suffix
instead (fb_scan_sb_logp_bts), so the walk needs no masking; absent
speakers have w == 0. bhat is only ever used up to a per-frame scale:
compare it after normalizing each frame.

Layout is [B, T, S] (one frame of one lane is S contiguous values), the
native layout of the E-step product. The speaker axis is not padded: the
TPU kernel padded S to 8/16 sublanes and B to 128 lanes for its tiles.
The TPU kernel held at most 256 speakers; this one holds S_MAX = 4096
(S > 256 spreads each chain over ceil(S / 256) warps), so the engine's
kernel route never has to leave the kernel on a card. Up to 256 speakers
a lane is a group of 1-32 threads sized from S alone, several lanes to a
warp; a lane's result does not depend on the batch it is launched in.

`fb_fused_sb` launches the CUDA kernel for CUDA tensors and runs
`fb_fused_sb_plain` only for CPU tensors; any other device raises. There is
no fallback: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from vbx_tpu_torch.ops import cuda_build

S_MAX = 4096         # speakers per lane the kernel holds (16 warps x 256)
_TINY = 1e-37
_IO_DTYPES = (torch.float32, torch.bfloat16)


def _check(w, col, pinit, binit):
    if w.dim() != 3:
        raise ValueError(f"w must be [B, T, S], got shape {tuple(w.shape)}")
    B, T, S = w.shape
    if B < 1 or T < 1 or S < 1:
        raise ValueError(f"empty w of shape {tuple(w.shape)}")
    if S > S_MAX:
        raise ValueError(f"S={S} > {S_MAX}: the fused kernel holds at most "
                         f"{S_MAX} speakers per lane")
    if w.dtype not in _IO_DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    for name, x in (("col", col), ("pinit", pinit), ("binit", binit)):
        if x.shape != (B, S) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [B, S] = {(B, S)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != w.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {w.device}")


def _launcher():
    """The kernel's C entry point (csrc/fb_fused_sb.cu), built and loaded
    at first use."""
    fn = cuda_build.library("fb_fused_sb").fb_fused_sb_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4)
    return fn


def fb_fused_sb(w: torch.Tensor, col: torch.Tensor, pinit: torch.Tensor,
                binit: torch.Tensor, loop_prob: float, recip: bool = False,
                skip_dead: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused forward-backward walk over [B, T, S] emission weights.

    w: [B, T, S] float32 or bfloat16; col, pinit, binit: [B, S] float32.
    Returns (ahat [B, T, S], bhat [B, T, S]) at w's dtype and cfw [B, T]
    float32. CUDA tensors launch the kernel (csrc/fb_fused_sb.cu); CPU
    tensors run fb_fused_sb_plain.
    """
    _check(w, col, pinit, binit)
    if w.device.type == "cpu":
        return fb_fused_sb_plain(w, col, pinit, binit, loop_prob, recip,
                                 skip_dead)
    if w.device.type != "cuda":
        raise ValueError(f"fb_fused_sb runs on cuda or cpu, not {w.device}")
    fn = _launcher()
    B, T, S = w.shape
    ahat = torch.empty_like(w)
    bhat = torch.empty_like(w)
    cfw = torch.empty((B, T), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = fn(w.data_ptr(), col.data_ptr(), pinit.data_ptr(),
                binit.data_ptr(), float(loop_prob), B, T, S,
                int(w.dtype == torch.bfloat16), int(recip), int(skip_dead),
                ahat.data_ptr(), bhat.data_ptr(), cfw.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fb_fused_sb kernel launch failed: CUDA error "
                           f"{rc} (B={B}, T={T}, S={S}, {w.dtype})")
    fb_fused_sb.launches += 1
    return ahat, bhat, cfw


fb_fused_sb.launches = 0   # kernel launches since the caller last reset it


def fb_fused_sb_plain(w: torch.Tensor, col: torch.Tensor, pinit: torch.Tensor,
                      binit: torch.Tensor, loop_prob: float,
                      recip: bool = False, skip_dead: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's walk, frame by frame in
    float32 as the TPU kernel steps, with the same flags and layout
    (carries stay float32; only the stored messages take w's dtype). The
    CUDA kernel sums a frame in another order (groups of threads, and the
    backward normalizer as lp * sum(u) + S * sum(col * u)) and takes an
    approximate reciprocal, so the two agree to the last few bits, not bit
    for bit. Used for CPU tensors and as the kernel's reference on the
    card."""
    B, T, S = w.shape
    f32 = torch.float32
    lp = torch.tensor(float(loop_prob), dtype=f32, device=w.device)
    tiny = torch.tensor(_TINY, dtype=f32, device=w.device)
    one = torch.ones((), dtype=f32, device=w.device)
    ahat = torch.empty_like(w)
    bhat = torch.empty_like(w)
    cfw = torch.empty((B, T), dtype=f32, device=w.device)

    fprev = torch.zeros((B, S), dtype=f32, device=w.device)
    for t in range(T):
        w_t = w[:, t].to(f32)
        a = w_t * pinit if t == 0 else w_t * (lp * fprev + col)
        c_raw = a.sum(-1, keepdim=True)
        c = torch.maximum(c_raw, tiny)
        af = a * (1.0 / c) if recip else a / c
        if skip_dead:
            live = c_raw > tiny
            af = torch.where(live, af, fprev)
            c = torch.where(live, c, one)
        ahat[:, t] = af.to(w.dtype)
        cfw[:, t] = c[:, 0]
        fprev = af

    bnext = binit
    bhat[:, T - 1] = binit.to(w.dtype)
    for j in range(T - 2, -1, -1):
        u = w[:, j + 1].to(f32) * bnext
        b = lp * u + (col * u).sum(-1, keepdim=True)
        cb_raw = b.sum(-1, keepdim=True)
        cb = torch.maximum(cb_raw, tiny)
        bn = b * (1.0 / cb) if recip else b / cb
        if skip_dead:
            bn = torch.where(cb_raw > tiny, bn, bnext)
        bhat[:, j] = bn.to(w.dtype)
        bnext = bn
    return ahat, bhat, cfw


def fb_scan_sb_logp_bts(log_p_bts: torch.Tensor, smask_bs: torch.Tensor,
                        valid: torch.Tensor, col: torch.Tensor,
                        pinit: torch.Tensor, loop_prob: float,
                        recip: bool = False,
                        io_dtype: torch.dtype = torch.float32,
                        binit: Optional[torch.Tensor] = None,
                        zero_invalid: bool = False):
    """Port of vbx_tpu.ops.fb_pallas.fb_scan_pallas_sb_logp_bts: builds the
    emission weights from [B, T, S] log-likelihoods (m = max_s log_p,
    w = exp(log_p - m) * smask, frames with valid == 0 uniform 1/S, or all
    zero with zero_invalid, which also turns on skip_dead) and runs the
    fused walk.

    log_p_bts: [B, T, S] float32 (absent speakers already NEG_INF).
    smask_bs:  [B, S] speaker validity. valid: [T, B] frame validity.
    col/pinit/binit: [S, B] as in vbx_tpu (binit=None: uniform 1/S, the
    sequential smoother's backward start).
    Returns (ahat, bhat, cfw [T, B], m [T, B], w [T, S, B]) in vbx_tpu's
    [T, S, B] order. They are views of the kernel's [B, T, S] buffers
    (`.permute(2, 0, 1)` gives those back without a copy).
    """
    B, T, S = log_p_bts.shape
    f32 = torch.float32
    vm = valid.to(f32).T[:, :, None]                          # [B, T, 1]
    m_bt = log_p_bts.amax(2)                                   # [B, T]
    w_core = (torch.exp(log_p_bts - m_bt[:, :, None])
              * smask_bs.to(f32)[:, None, :])
    if zero_invalid:
        w = (w_core * vm).to(io_dtype)
    else:
        w = (w_core * vm + (1.0 - vm) / S).to(io_dtype)
    if binit is None:
        binit_bs = torch.full((B, S), 1.0 / S, dtype=f32,
                              device=log_p_bts.device)
    else:
        binit_bs = binit.T.to(f32).contiguous()
    ahat, bhat, cfw = fb_fused_sb(
        w, col.T.to(f32).contiguous(), pinit.T.to(f32).contiguous(),
        binit_bs, loop_prob, recip=recip, skip_dead=zero_invalid)
    return (ahat.permute(1, 2, 0), bhat.permute(1, 2, 0), cfw.T, m_bt.T,
            w.permute(1, 2, 0))
