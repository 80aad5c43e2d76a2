"""HMM forward-backward smoothers (port of vbx_tpu.ops.forward_backward).

Same recursion as the reference (VBx/VBx.py:146-175) including its
`log(tr + eps)` / `log(ip + eps)` regularization. The sequential variants
use the *scaled* linear-domain form (the reference's unnormalized
log-domain recursion drifts by >1.0 of posterior mass in f32 at T~1000):

    w_t   = exp(log_p[t] - m_t),              m_t = max_s log_p[t, s]
    a_t   = w_t * (ahat_{t-1} @ (tr + eps)),  c_t = sum_s a_t,  ahat_t = a_t/c_t
    b_t   = (tr + eps) @ (w_{t+1} * bhat_{t+1}),  normalized likewise

Posteriors and the pi-update statistic follow in linear domain:

    gamma_t   = ahat_t * bhat_t / sum_s(ahat_t[s] * bhat_t[s])
    pi_stat_s = sum_{t>=1} w_t[s] * bhat_t[s] * r_t / c_t,
                r_t = 1 / sum_s(ahat_t[s] * bhat_t[s])

Three algorithms:

1. `forward_backward_structured`: with tr = loopP*I + (1-loopP)*1 pi^T
   (VBx/VBx.py:98) and the constant +eps the S^2 products collapse exactly
   to O(S) per frame:
       a_t = w_t * (loopP * ahat_{t-1} + ((1-loopP)*pi + eps))
   The port's structured engine, its float64 route, and the reference the
   CUDA kernels (ops.fb_kernel, ops.fb_scan_kernel) are tested against.
2. `forward_backward_dense`: general dense-transition smoother (any HMM),
   O(S^2) per frame; the parity oracle for (1) and the API for arbitrary
   transition matrices. Its per-step matvec runs at full float32
   (device.full_fp32_matmuls).
3. `forward_backward_assoc`: the work-parallel form. Per-frame transition
   operators are composed in the (logsumexp, +) semiring by a log-depth
   scan over T; each element is a max-normalized [S, S] log-matrix plus a
   scalar log-scale, so composed operators stay O(1) and float32-exact at
   any T, and the per-frame outputs are assembled from
   within-frame-normalized quantities only. PyTorch has no associative scan:
   `_associative_scan` is the recursive odd/even scheme in plain torch.

vbx_tpu's `lax.scan` becomes a Python loop over frames that advances the
forward recursion ascending and the backward recursion descending in the
same step, on [B, S] tensors. `frame_mask` False entries must form a
suffix; padded frames are skipped exactly (forward carries freeze, backward
messages pass through, normalizer contributions are zeroed), so a padded
recording's posteriors equal its unpadded run's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from vbx_tpu_torch.device import full_fp32_matmuls
from vbx_tpu_torch.ops.lse import NEG_INF, logsumexp


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


def _scaled_fb(log_p, init_vec, fwd_apply, bwd_apply, valid) -> FBResult:
    """Shared loop of the sequential scaled smoothers over [B, T, S]:
    both normalized recursions given the transition applications
    fwd_apply(prev_row_vec) and bwd_apply(next_col_vec) (one loop step = one
    forward frame ascending + one backward frame descending; they are
    independent)."""
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
        a = w[:, i] * fwd_apply(fprev)                   # sum_s fprev == 1
        c = a.sum(-1)
        fprev = torch.where(valid_t, a / c[:, None], fprev)
        ahats.append(fprev)
        cfs.append(c)

        j = T - 1 - i                   # backward frame, reads w[j + 1]
        b = bwd_apply(w[:, j + 1] * bnext)
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


def _batched(log_p, frame_mask, *per_lane):
    """Lift single-recording inputs ([T, S] log_p) to a batch of one.
    Returns (single, log_p, valid, per_lane...)."""
    single = log_p.dim() == 2
    if single:
        log_p = log_p[None]
        per_lane = tuple(x[None] for x in per_lane)
        if frame_mask is not None:
            frame_mask = frame_mask[None]
    valid = (torch.ones(log_p.shape[:2], dtype=torch.bool,
                        device=log_p.device)
             if frame_mask is None else frame_mask.to(torch.bool))
    return (single, log_p, valid) + per_lane


def _unbatched(single: bool, res: FBResult) -> FBResult:
    return FBResult(*(x[0] for x in res)) if single else res


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
    single, log_p, valid, pi = _batched(log_p, frame_mask, pi)
    dtype, dev = log_p.dtype, log_p.device
    pi = pi.to(dtype)
    loop_prob = torch.as_tensor(loop_prob, dtype=dtype, device=dev)
    eps = torch.as_tensor(eps, dtype=dtype, device=dev)
    col = (1.0 - loop_prob) * pi + eps   # constant transition column + eps
    res = _scaled_fb(
        log_p, pi + eps,
        lambda prev: loop_prob * prev + col,
        # row-constant term
        lambda u: loop_prob * u + (col * u).sum(-1, keepdim=True),
        valid)
    return _unbatched(single, res)


def forward_backward_dense(
    log_p: torch.Tensor,
    tr: torch.Tensor,
    ip: torch.Tensor,
    eps: float = 1e-8,
    frame_mask: Optional[torch.Tensor] = None,
) -> FBResult:
    """General dense-transition scaled smoother (any S x S tr).

    log_p: [T, S] or [B, T, S]; tr: [S, S] (or [B, S, S] with a batched
    log_p); ip: [S] or [B, S] initial probabilities. The per-step matvec
    runs at full float32 (TF32 off): the general path is
    reference-faithful."""
    single, log_p, valid, ip = _batched(log_p, frame_mask, ip)
    dtype, dev = log_p.dtype, log_p.device
    eps = torch.as_tensor(eps, dtype=dtype, device=dev)
    tr_eps = tr.to(dtype) + eps
    with full_fp32_matmuls():
        res = _scaled_fb(
            log_p, ip.to(dtype) + eps,
            lambda prev: torch.matmul(prev[:, None, :], tr_eps)[:, 0, :],
            lambda u: torch.matmul(tr_eps, u[:, :, None])[:, :, 0],
            valid)
    return _unbatched(single, res)


def _log_matmul_scaled(a, b):
    """(logsumexp, +) semiring composition of max-normalized operators.

    Elements are (mat [..., S, S], scale [...]); compose then re-normalize
    so matrix entries stay O(1) in f32 at any composition depth.
    """
    a_mat, a_scale = a
    b_mat, b_scale = b
    out = logsumexp(a_mat[..., :, :, None] + b_mat[..., None, :, :], dim=-2)
    mx = torch.clamp(out.amax((-2, -1), keepdim=True), min=NEG_INF)
    return out - mx, a_scale + b_scale + mx[..., 0, 0]


def _associative_scan(fn, elems, reverse: bool = False):
    """Inclusive scan of the associative `fn` over axis 0 of every tensor in
    the tuple `elems`, in log2(n) depth: combine neighbouring pairs, scan
    the half-length result (the prefixes at odd positions), then one more
    combine gives the even positions. `fn` need not be commutative: the
    left operand is always the earlier index. reverse=True scans from the
    last index down (fn then receives the later index on the left)."""
    if reverse:
        out = _associative_scan(fn, tuple(e.flip(0) for e in elems))
        return tuple(e.flip(0) for e in out)
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems),
                 tuple(e[1::2] for e in elems))
    odd = _associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    out = []
    for first, ev, od in zip(elems, even, odd):
        o = first.new_empty(first.shape)
        o[0] = first[0]
        o[2::2] = ev
        o[1::2] = od
        out.append(o)
    return tuple(out)


def forward_backward_assoc(
    log_p: torch.Tensor,
    pi: torch.Tensor,
    loop_prob,
    eps: float = 1e-8,
    frame_mask: Optional[torch.Tensor] = None,
) -> FBResult:
    """Work-parallel smoother via associative operator scans (see module
    docstring). O(T * S^3) elementwise work in log2(T) depth, no sequential
    T dependency. log_p: [T, S] or [B, T, S], as the structured smoother.
    The largest intermediate is [T/2, (B,) S, S, S]."""
    single, log_p, valid, pi = _batched(log_p, frame_mask, pi)
    dtype, dev = log_p.dtype, log_p.device
    B, T, S = log_p.shape
    pi = pi.to(dtype)
    # time-major inside: the scans run over axis 0
    log_p = log_p.transpose(0, 1)                              # [T, B, S]
    valid = valid.T                                            # [T, B]
    vf = valid.to(dtype)

    loop_prob = torch.as_tensor(loop_prob, dtype=dtype, device=dev)
    eps_c = torch.as_tensor(eps, dtype=dtype, device=dev)
    eye = torch.eye(S, dtype=dtype, device=dev)
    ltr = torch.log(eye * loop_prob + (1.0 - loop_prob) * pi[:, None, :]
                    + eps_c)                                   # [B, S, S]
    neg = torch.full((), NEG_INF, dtype=dtype, device=dev)
    log_eye = torch.where(eye.bool(), torch.zeros((), dtype=dtype,
                                                  device=dev), neg)

    lfw0 = log_p[0] + torch.log(pi + eps_c)                    # [B, S]
    lfw0_m = lfw0.amax(-1)
    lfw0_hat = lfw0 - lfw0_m[:, None]

    # Per-frame operators A_t[j, i] = ltr[j, i] + log_p[t, i] for t >= 1,
    # identity at padded frames, max-normalized with separate scales.
    a_mat = ltr[None] + log_p[1:, :, None, :]                  # [T-1,B,S,S]
    a_mat = torch.where(valid[1:, :, None, None], a_mat, log_eye)
    a_scale = a_mat.amax((-2, -1))
    a_mat = a_mat - a_scale[..., None, None]

    pre_mat, pre_scale = _associative_scan(_log_matmul_scaled,
                                           (a_mat, a_scale))
    lfw_rest = (logsumexp(lfw0_hat[None, :, :, None] + pre_mat, dim=-2)
                + (lfw0_m + pre_scale)[..., None])
    lfw = torch.cat([lfw0[None], lfw_rest], 0)

    # the reverse scan composes in descending index order, so swap the
    # operands to get suffix[t] = A_t (x) A_{t+1} (x) ... (x) A_{T-1}
    suf_mat, suf_scale = _associative_scan(
        lambda x, y: _log_matmul_scaled(y, x), (a_mat, a_scale),
        reverse=True)
    lbw_rest = logsumexp(suf_mat, dim=-1) + suf_scale[..., None]
    lbw = torch.cat([lbw_rest, torch.zeros((1, B, S), dtype=dtype,
                                           device=dev)], 0)

    log_px = logsumexp(lfw[-1], dim=-1)

    # gamma via per-frame normalization: within a frame every lfw/lbw entry
    # shares its composed-operator scale, so relative precision is O(eps)
    # of the dtype regardless of T.
    z = lfw + lbw
    ez = torch.exp(z - z.amax(-1, keepdim=True))
    gamma = ez / ez.sum(-1, keepdim=True) * vf[..., None]

    # pi_stat without large-magnitude cancellation. Substituting the forward
    # recursion lfw[t] = LSE_j(lfw[t-1, j] + ltr[j, s]) + log_p[t, s] into
    # the reference expression and normalizing per frame
    # (fhat = lfw[t-1] - LSE(lfw[t-1]), ghat = lbw[t] - max(lbw[t])):
    #   terms[t, s] = exp(log_p[t, s] + ghat[t, s] - D_t)
    #   D_t = LSE_s( LSE_j(fhat[j] + ltr[j, s]) + log_p[t, s] + ghat[t, s] )
    # with every operand O(1); the absolute scales cancel identically.
    fhat = lfw[:-1] - logsumexp(lfw[:-1], dim=-1, keepdim=True)
    ghat = lbw[1:] - lbw[1:].amax(-1, keepdim=True)
    # structured transition: LSE_j(fhat[j] + ltr[j, s]) =
    #   log(loopP * exp(fhat[s]) + ((1-loopP) pi_s + eps) * sum_j exp(fhat)_j)
    ef = torch.exp(fhat)
    trans = torch.log(loop_prob * ef + ((1.0 - loop_prob) * pi + eps_c)[None]
                      * ef.sum(-1, keepdim=True))
    log_terms_hat = log_p[1:] + ghat
    D = logsumexp(trans + log_terms_hat, dim=-1, keepdim=True)
    terms = torch.exp(log_terms_hat - D)
    pi_stat = (terms * vf[1:, :, None]).sum(0)
    res = FBResult(gamma.transpose(0, 1), log_px, lfw.transpose(0, 1),
                   lbw.transpose(0, 1), pi_stat)
    return _unbatched(single, res)
