"""Structured scaled forward-backward smoother (port of the sequential
route of vbx_tpu.ops.forward_backward).

Same recursion as the reference (VBx/VBx.py:146-175) including its
`log(tr + eps)` / `log(ip + eps)` regularization, in the *scaled*
linear-domain form (the reference's unnormalized log-domain recursion
drifts by >1.0 of posterior mass in f32 at T~1000):

    w_t   = exp(log_p[t] - m_t),              m_t = max_s log_p[t, s]
    a_t   = w_t * (ahat_{t-1} @ (tr + eps)),  c_t = sum_s a_t,  ahat_t = a_t/c_t
    b_t   = (tr + eps) @ (w_{t+1} * bhat_{t+1}),  normalized likewise

With tr = loopP*I + (1-loopP)*1 pi^T (VBx/VBx.py:98) and the constant +eps
the S^2 products collapse exactly to O(S) per frame:

    a_t = w_t * (loopP * ahat_{t-1} + ((1-loopP)*pi + eps))

Posteriors and the pi-update statistic follow in linear domain:

    gamma_t   = ahat_t * bhat_t / sum_s(ahat_t[s] * bhat_t[s])
    pi_stat_s = sum_{t>=1} w_t[s] * bhat_t[s] * r_t / c_t,
                r_t = 1 / sum_s(ahat_t[s] * bhat_t[s])

This is the port's structured engine, its float64 route, and the reference
the CUDA kernel (ops.fb_kernel) is tested against. vbx_tpu's `lax.scan`
becomes a Python loop over frames that advances the forward recursion
ascending and the backward recursion descending in the same step, on
[B, S] tensors. `frame_mask` False entries must form a suffix; padded
frames are skipped exactly (forward carries freeze, backward messages pass
through, normalizer contributions are zeroed), so a padded recording's
posteriors equal its unpadded run's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class FBResult(NamedTuple):
    gamma: torch.Tensor     # [..., T, S] posteriors (zeroed at padded frames)
    log_px: torch.Tensor    # [...] total log-likelihood
    lfw: torch.Tensor       # [..., T, S] log forward probabilities
    lbw: torch.Tensor       # [..., T, S] log backward probabilities
    pi_stat: torch.Tensor   # [..., S] transition-occupation stat for the pi
    #   update: sum_{t>=1} exp(LSE_j lfw[t-1,j] + log_p[t] + lbw[t] - log_px)
    #   (the reference computes this inline at VBx/VBx.py:101-103)


def _normalize_logp(log_p, valid):
    """Per-frame max-shift: (w = exp(log_p - m), m). Padded frames get
    uniform w at m = 0 (they are carried through by the scans anyway)."""
    m = log_p.amax(-1)
    m = torch.where(valid, m, torch.zeros_like(m))
    w = torch.exp(log_p - m[..., None])
    w = torch.where(valid[..., None], w,
                    torch.ones_like(w) / log_p.shape[-1])
    return w, m


def _finish(ahat, bhat, w, cf_steps, cb_steps, cfw, valid) -> FBResult:
    """Assemble FBResult from scaled quantities ([B, T, S] / [B, T]).

    ahat, bhat: normalized forward/backward messages (rows sum to 1).
    cf_steps:   forward log-normalizer increments (m_t + log c_t), zero at
                padded frames; cf_steps[:, 0] covers frame 0.
    cb_steps:   backward increments (cb_steps[:, T-1] = log S so that
                lbw[T-1] reconstructs to exactly 0).
    cfw:        linear forward normalizers c_t (1 at padded frames).
    """
    dtype = ahat.dtype
    tiny = torch.finfo(dtype).tiny
    vf = valid.to(dtype)
    log_px = cf_steps.sum(-1)

    ab = ahat * bhat
    denom = torch.clamp(ab.sum(-1, keepdim=True), min=tiny)
    gamma = (ab / denom) * vf[..., None]

    r_over_c = 1.0 / (denom[:, 1:, 0] * cfw[:, 1:])
    terms = w[:, 1:] * bhat[:, 1:] * r_over_c[..., None]
    pi_stat = (terms * vf[:, 1:, None]).sum(-2)

    # reference-scale lfw/lbw for debugging/tests
    cf = torch.cumsum(cf_steps, -1)
    cb = torch.flip(torch.cumsum(torch.flip(cb_steps, (-1,)), -1), (-1,))
    lfw = torch.log(torch.clamp(ahat, min=tiny)) + cf[..., None]
    lbw = torch.log(torch.clamp(bhat, min=tiny)) + cb[..., None]
    return FBResult(gamma, log_px, lfw, lbw, pi_stat)


def _scaled_fb_structured(log_p, init_vec, loop_prob, col, valid) -> FBResult:
    """Both normalized recursions of the structured smoother over [B, T, S]
    (one loop step = one forward frame ascending + one backward frame
    descending; they are independent)."""
    B, T, S = log_p.shape
    w, m = _normalize_logp(log_p, valid)

    a0 = w[:, 0] * init_vec
    c0 = a0.sum(-1)
    fprev = a0 / c0[:, None]
    bnext = torch.ones((B, S), dtype=w.dtype, device=w.device) / S
    ahats, cfs = [fprev], [c0]
    bhats, cbs = [bnext], []
    for i in range(1, T):
        valid_t = valid[:, i, None]
        a = w[:, i] * (loop_prob * fprev + col)          # sum_s fprev == 1
        c = a.sum(-1)
        fprev = torch.where(valid_t, a / c[:, None], fprev)
        ahats.append(fprev)
        cfs.append(c)

        j = T - 1 - i                   # backward frame, reads w[j + 1]
        u = w[:, j + 1] * bnext
        b = loop_prob * u + (col * u).sum(-1, keepdim=True)
        cb = b.sum(-1)
        bnext = torch.where(valid[:, j + 1, None], b / cb[:, None], bnext)
        bhats.append(bnext)
        cbs.append(cb)

    ahat = torch.stack(ahats, 1)
    bhat = torch.stack(bhats[::-1], 1)
    c_fw = torch.stack(cfs, 1)                                  # [B, T]
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    # frame 0 counts unconditionally, as in vbx_tpu's scan
    v0 = valid.clone()
    v0[:, 0] = True
    cf_steps = torch.where(v0, m + torch.log(c_fw), zero)
    cfw = torch.where(v0, c_fw, torch.ones_like(c_fw))
    logS = torch.full((B, 1), math.log(S), dtype=w.dtype, device=w.device)
    if T > 1:
        c_bw = torch.stack(cbs[::-1], 1)                        # [B, T-1]
        cb_rest = torch.where(valid[:, 1:], m[:, 1:] + torch.log(c_bw), zero)
        cb_steps = torch.cat([cb_rest, logS], 1)
    else:
        cb_steps = logS
    return _finish(ahat, bhat, w, cf_steps, cb_steps, cfw, valid)


def forward_backward_structured(
    log_p: torch.Tensor,
    pi: torch.Tensor,
    loop_prob,
    eps: float = 1e-8,
    frame_mask: Optional[torch.Tensor] = None,
) -> FBResult:
    """O(S)-per-frame exact smoother for tr = loopP*I + (1-loopP)*1 pi^T.

    log_p: [T, S] or [B, T, S]; pi: [S] or [B, S]; frame_mask: [T] / [B, T]
    bool (False entries a suffix). Outputs keep the input's batch rank.
    """
    single = log_p.dim() == 2
    if single:
        log_p = log_p[None]
        pi = pi[None]
        if frame_mask is not None:
            frame_mask = frame_mask[None]
    dtype, dev = log_p.dtype, log_p.device
    pi = pi.to(dtype)
    valid = (torch.ones(log_p.shape[:2], dtype=torch.bool, device=dev)
             if frame_mask is None else frame_mask.to(torch.bool))
    loop_prob = torch.as_tensor(loop_prob, dtype=dtype, device=dev)
    eps = torch.as_tensor(eps, dtype=dtype, device=dev)
    col = (1.0 - loop_prob) * pi + eps   # constant transition column + eps
    res = _scaled_fb_structured(log_p, pi + eps, loop_prob, col, valid)
    if single:
        res = FBResult(*(x[0] for x in res))
    return res
