"""Scaled forward-backward recursions in the time-major [T, B, S] layout:
the CUDA kernels that replace vbx_tpu/ops/fb_pallas.py's `_fused_kernel`,
`_fwd_kernel` and `_bwd_kernel`, their plain PyTorch twins, and `fb_scan`,
the counterpart of `fb_scan_pallas` (the general [T, B, S] API that the
kernel A/B tool, scripts/torch_ab_fb_kernels.py, drives).

Per recording lane (see ops.forward_backward for the derivation):

    forward:  a_t = w_t * (lp * ahat_{t-1} + col),  a_0 = w_0 * pinit,
              c_t = max(sum_s a_t, 1e-37),          ahat_t = a_t / c_t
    backward: u = w_{t+1} * bhat_{t+1},  b_t = lp * u + sum_s(col * u),
              bhat_t = b_t / max(sum_s b_t, 1e-37),  bhat_{T-1} = 1 / S

Three kernels in csrc/fb_scan_tbs.cu, one wrapper each with its launch
counter and its twin:

- `fb_scan_fused` (twin `fb_scan_fused_plain`): both recursions in one
  launch; returns (ahat, bhat). `fb_scan(fused=True)` rebuilds the forward
  normalizers from ahat in one elementwise pass, as vbx_tpu's wrapper does.
- `fb_scan_fwd` (twin `fb_scan_fwd_plain`): the forward pass alone; returns
  (ahat, cfw [T, B]).
- `fb_scan_bwd` (twin `fb_scan_bwd_plain`): the backward pass alone;
  returns bhat.

Everything is float32 (the TPU kernels of this layout have no bfloat16, no
reciprocal and no boundary-message mode). S is not padded to the TPU's 128
lanes: invalid frames are filled with 1/S and the backward chain starts
from 1/S where vbx_tpu uses 1/128, so bhat and cfw at invalid frames differ
from vbx_tpu's by a scale, which the API declares arbitrary; on valid frames
ahat, gamma, log_px and pi_stat are unchanged. Compare bhat only after
normalizing each frame.

A wrapper launches its CUDA kernel for CUDA tensors and runs its twin only
for CPU tensors; any other device raises. There is no fallback: a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vbx_tpu_torch.ops import cuda_build

S_MAX = 128          # the [T, B, S] API's cap (vbx_tpu's lane tile)
_TINY = 1e-37


def _check(w, col, pinit=None):
    if w.dim() != 3:
        raise ValueError(f"w must be [T, B, S], got shape {tuple(w.shape)}")
    T, B, S = w.shape
    if T < 1 or B < 1 or S < 1:
        raise ValueError(f"empty w of shape {tuple(w.shape)}")
    if S > S_MAX:
        raise ValueError(f"S={S} > {S_MAX} lanes; shard speakers first")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    if w.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fb_scan runs on cuda or cpu, not {w.device}")
    for name, x in (("col", col), ("pinit", pinit)):
        if x is None:
            continue
        if x.shape != (B, S) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [B, S] = {(B, S)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != w.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {w.device}")


def _launcher(entry: str, n_pointers_in: int, n_pointers_out: int):
    """C entry point `entry` of csrc/fb_scan_tbs.cu, built and loaded at
    first use: (inputs..., float lp, int T, int B, int S, outputs...,
    stream)."""
    fn = getattr(cuda_build.library("fb_scan_tbs"), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_pointers_in + [ctypes.c_float]
                       + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * (n_pointers_out + 1))
    return fn


def _launch(fn, name, w, ins, lp, outs):
    T, B, S = w.shape
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = fn(*(x.data_ptr() for x in ins), float(lp), T, B, S,
                *(x.data_ptr() for x in outs), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"(T={T}, B={B}, S={S})")


def fb_scan_fused(w: torch.Tensor, col: torch.Tensor, pinit: torch.Tensor,
                  loop_prob: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both recursions in one launch over [T, B, S] float32 emission
    weights (col, pinit: [B, S]). Returns (ahat, bhat), both [T, B, S]."""
    _check(w, col, pinit)
    if w.device.type == "cpu":
        return fb_scan_fused_plain(w, col, pinit, loop_prob)
    fn = _launcher("fb_scan_fused_launch", 3, 2)
    ahat, bhat = torch.empty_like(w), torch.empty_like(w)
    _launch(fn, "fb_scan_fused", w, (w, col, pinit), loop_prob, (ahat, bhat))
    fb_scan_fused.launches += 1
    return ahat, bhat


def fb_scan_fwd(w: torch.Tensor, col: torch.Tensor, pinit: torch.Tensor,
                loop_prob: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward pass alone. Returns (ahat [T, B, S], cfw [T, B])."""
    _check(w, col, pinit)
    if w.device.type == "cpu":
        return fb_scan_fwd_plain(w, col, pinit, loop_prob)
    fn = _launcher("fb_scan_fwd_launch", 3, 2)
    ahat = torch.empty_like(w)
    cfw = torch.empty(w.shape[:2], dtype=torch.float32, device=w.device)
    _launch(fn, "fb_scan_fwd", w, (w, col, pinit), loop_prob, (ahat, cfw))
    fb_scan_fwd.launches += 1
    return ahat, cfw


def fb_scan_bwd(w: torch.Tensor, col: torch.Tensor,
                loop_prob: float) -> torch.Tensor:
    """The backward pass alone (reads w[t + 1] for frame t; uniform 1/S at
    the last frame). Returns bhat [T, B, S]."""
    _check(w, col)
    if w.device.type == "cpu":
        return fb_scan_bwd_plain(w, col, loop_prob)
    fn = _launcher("fb_scan_bwd_launch", 2, 1)
    bhat = torch.empty_like(w)
    _launch(fn, "fb_scan_bwd", w, (w, col), loop_prob, (bhat,))
    fb_scan_bwd.launches += 1
    return bhat


# kernel launches since the caller last reset them
fb_scan_fused.launches = 0
fb_scan_fwd.launches = 0
fb_scan_bwd.launches = 0


def _consts(w, loop_prob):
    f32 = torch.float32
    return (torch.tensor(float(loop_prob), dtype=f32, device=w.device),
            torch.tensor(_TINY, dtype=f32, device=w.device))


def fb_scan_fwd_plain(w: torch.Tensor, col: torch.Tensor,
                      pinit: torch.Tensor, loop_prob: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel's walk, frame by frame.
    Used for CPU tensors and as the kernel's reference on the card."""
    T = w.shape[0]
    lp, tiny = _consts(w, loop_prob)
    ahat = torch.empty_like(w)
    cfw = torch.empty(w.shape[:2], dtype=torch.float32, device=w.device)
    prev = None
    for t in range(T):
        a = w[t] * pinit if t == 0 else w[t] * (lp * prev + col)
        c = torch.maximum(a.sum(-1, keepdim=True), tiny)
        prev = a / c
        ahat[t] = prev
        cfw[t] = c[:, 0]
    return ahat, cfw


def fb_scan_bwd_plain(w: torch.Tensor, col: torch.Tensor,
                      loop_prob: float) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel's walk."""
    T, _, S = w.shape
    lp, tiny = _consts(w, loop_prob)
    bhat = torch.empty_like(w)
    nxt = torch.full_like(w[0], 1.0 / S)
    bhat[T - 1] = nxt
    for t in range(T - 2, -1, -1):
        u = w[t + 1] * nxt
        b = lp * u + (col * u).sum(-1, keepdim=True)
        nxt = b / torch.maximum(b.sum(-1, keepdim=True), tiny)
        bhat[t] = nxt
    return bhat


def fb_scan_fused_plain(w: torch.Tensor, col: torch.Tensor,
                        pinit: torch.Tensor, loop_prob: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused kernel: the two independent
    chains one after the other; the forward normalizers are dropped, as the
    kernel drops them."""
    return (fb_scan_fwd_plain(w, col, pinit, loop_prob)[0],
            fb_scan_bwd_plain(w, col, loop_prob))


def fb_scan(w: torch.Tensor, valid: torch.Tensor, col: torch.Tensor,
            pinit: torch.Tensor, loop_prob: float, fused: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run both scaled recursions (port of vbx_tpu's fb_scan_pallas).

    w:      [T, B, S] per-frame emission weights exp(log_p - m) (absent
            speakers MUST be exactly 0; padded-frame values are ignored).
    valid:  [T, B] float/bool frame validity (False = padding suffix;
            frame 0 must be valid). Outputs at invalid frames are
            arbitrary: mask them downstream.
    col:    [B, S] transition column (1-loopP)*pi + eps.
    pinit:  [B, S] pi + eps initial weights.
    fused:  the single bidirectional kernel (default) or the two-pass
            kernels.
    Returns (ahat [T, B, S], bhat [T, B, S], cfw [T, B]), float32.
    """
    if w.dim() != 3:
        raise ValueError(f"w must be [T, B, S], got shape {tuple(w.shape)}")
    S = w.shape[-1]
    if S > S_MAX:
        raise ValueError(f"S={S} > {S_MAX} lanes; shard speakers first")
    f32 = torch.float32
    # padded/invalid frames -> uniform emissions: going backward a uniform
    # w keeps the carry uniform, so the message entering the last valid
    # frame is the uniform vector the sequential smoother starts from
    vmask = valid.to(f32)[:, :, None]
    w = (w.to(f32) * vmask + (1.0 - vmask) / S).contiguous()
    col = col.to(f32).contiguous()
    pinit = pinit.to(f32).contiguous()
    if fused:
        ahat, bhat = fb_scan_fused(w, col, pinit, loop_prob)
        # per-frame forward normalizers, rebuilt in one elementwise+reduce
        # pass: c_t = sum_s w_t (lp * ahat_{t-1} + col), c_0 = sum_s w_0 pinit
        prev = torch.cat([pinit[None], loop_prob * ahat[:-1] + col[None]], 0)
        cfw = torch.clamp((w * prev).sum(-1), min=_TINY)
        return ahat, bhat, cfw
    ahat, cfw = fb_scan_fwd(w, col, pinit, loop_prob)
    return ahat, fb_scan_bwd(w, col, loop_prob), cfw
