"""Batched VB-HMM diarization engine (port of vbx_tpu.engine.vbhmm).

Runs the VBx EM loop — M-step speaker-model estimation, per-frame expected
log-likelihoods, scaled forward-backward, ELBO and speaker-prior updates —
with the reference loop's semantics (VBx/VBx.py:27-126):

- iteration 0 never triggers the convergence check (VBx.py:122),
- convergence is Delta-ELBO < epsilon, checked after the state update, so
  the crossing iteration's gamma/pi are kept,
- optionally-provided (alpha, invL) skip the first M-step (VBx.py:94),
- the pi update uses the alpha-recursion occupation statistic
  (VBx.py:101-104).

Recordings are padded to common [T, S] with boolean masks, and a batch keeps
stepping until its slowest recording converges; converged recordings freeze
(their state stops changing and their ELBO column is written NaN), which
reproduces the reference's per-recording early stopping exactly.

Routes:
- structured (`vbx`, `vbx_batched(fb_impl=None/'structured')`): the
  sequential smoother of ops.forward_backward at the input dtype (float64
  available), the reference-exact route; `fb_impl='assoc'` runs the same
  loop over the work-parallel associative-scan smoother;
- kernel (`fb_impl='pallas'` / `'pallas_bf16'`, names kept from vbx_tpu so
  presets and flags are unchanged): float32 EM around the fused CUDA
  forward-backward kernel (ops.fb_kernel), with float32 or bfloat16 streams.

vbx_tpu runs the loop as one device `while_loop`. Here the host drives it,
and checking "all converged" costs a device sync, so the host checks every
CHECK_EVERY iterations: iterations run after every lane has converged change
nothing (frozen lanes keep their state and their ELBO columns stay NaN), so
the results equal an every-iteration check (tests/test_torch_vbhmm.py).
"""

from __future__ import annotations

import math
import os
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from vbx_tpu_torch.device import full_fp32_matmuls, resolve_device
from vbx_tpu_torch.ops.fb_kernel import S_MAX, fb_scan_sb_logp_bts
from vbx_tpu_torch.ops.forward_backward import (
    forward_backward_assoc, forward_backward_structured)
from vbx_tpu_torch.ops.lse import NEG_INF, masked_fill
from vbx_tpu_torch.ops.vb_steps import (
    vb_elbo_model_term, vb_log_likelihoods, vb_m_step, vb_pi_update,
    vb_precompute)

# EM iterations between the host's "all converged?" checks (device syncs)
CHECK_EVERY = 4

_FB_IMPLS = {
    "structured": forward_backward_structured,
    "assoc": forward_backward_assoc,
}
_KERNEL_IMPLS = {"pallas": torch.float32, "pallas_bf16": torch.bfloat16}


class VBxResult(NamedTuple):
    gamma: torch.Tensor    # [(B,) T, S] final responsibilities
    pi: torch.Tensor       # [(B,) S] final speaker priors
    elbo: torch.Tensor     # [(B,) max_iters] ELBO trace (NaN past convergence)
    n_iters: torch.Tensor  # [(B,)] int32: iterations actually run
    alpha: torch.Tensor    # [(B,) S, D] final speaker means
    invL: torch.Tensor     # [(B,) S, D] final speaker posterior covariances


def _plateau_step(delta, elbo_val, counter, plateau_ulps, plateau_iters,
                  eps_machine):
    """Opt-in f32 plateau stop (PARITY.md deviation 3): a lane's counter
    increments when |Delta-ELBO| is within `plateau_ulps` machine quanta of
    its ELBO's magnitude and resets otherwise; reaching `plateau_iters`
    consecutive small deltas freezes the lane like the reference epsilon
    rule. plateau_ulps <= 0 disables (the default). The quantum scales with
    the engine dtype, so an f64 run is never touched by an f32-tuned
    setting."""
    quantum = eps_machine * torch.clamp(torch.abs(elbo_val), min=1.0)
    small = torch.abs(delta) <= plateau_ulps * quantum
    new_counter = torch.where(small, counter + 1, torch.zeros_like(counter))
    hit = (plateau_ulps > 0) & (new_counter >= plateau_iters)
    return new_counter, hit


def _run_em(step, state, max_iters: int):
    """Drive `step(state, it) -> state` for up to max_iters iterations,
    stopping once every lane has converged (checked every CHECK_EVERY
    iterations; see the module docstring)."""
    for it in range(max_iters):
        if it % CHECK_EVERY == 0 and bool(state["converged"].all()):
            break
        state = step(state, it)
    return state


def _em_structured(X, phi, gamma, pi, frame_mask, speaker_mask, loop_prob,
                   fa, fb, epsilon, alpha0, invL0, converged0, last_elbo0,
                   plateau_ulps, plateau_iters, plateau0, *, max_iters: int,
                   has_initial_model: bool,
                   fb_impl: str = "structured") -> VBxResult:
    """Batched [B, ...] counterpart of vbx_tpu's `_vbx_jit` under vmap: the
    `fb_impl` smoother of _FB_IMPLS at X's dtype, per-lane freezing."""
    fb_fn = _FB_IMPLS[fb_impl]
    dtype, dev = X.dtype, X.device
    B, T, D = X.shape

    def scalar(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    loop_prob, fa, fb, epsilon = map(scalar, (loop_prob, fa, fb, epsilon))
    plateau_ulps = scalar(plateau_ulps)
    eps_machine = scalar(torch.finfo(dtype).eps)
    G, rho = vb_precompute(X, phi)
    fa_over_fb = fa / fb
    smask = speaker_mask.to(torch.bool)

    # zero out padded frames/speakers in the initial responsibilities
    gamma = (gamma * frame_mask[:, :, None].to(dtype)
             * speaker_mask[:, None, :].to(dtype))
    pi = pi * speaker_mask.to(dtype)
    # a resumed run (finite last_elbo0) is mid-trajectory: its first
    # iteration may trigger convergence against the carried ELBO
    fresh = last_elbo0 == scalar(NEG_INF)

    def step(st, it):
        first = fresh & (it == 0)                                   # [B]
        invL, alpha = vb_m_step(st["gamma"], rho, phi, fa_over_fb)
        if has_initial_model and it == 0:
            f3 = first[:, None, None]
            invL = torch.where(f3, st["invL"], invL)
            alpha = torch.where(f3, st["alpha"], alpha)
        log_p = vb_log_likelihoods(rho, G, invL, alpha, phi, fa)
        log_p = masked_fill(log_p, smask[:, None, :])
        fbr = fb_fn(log_p, st["pi"], loop_prob, frame_mask=frame_mask)
        elbo_val = fbr.log_px + vb_elbo_model_term(invL, alpha, fb)
        new_pi = vb_pi_update(fbr.gamma[:, 0], st["pi"], fbr.pi_stat,
                              loop_prob)
        delta = elbo_val - st["last_elbo"]
        new_plateau, hit = _plateau_step(delta, elbo_val, st["plateau"],
                                         plateau_ulps, plateau_iters,
                                         eps_machine)
        now_conv = ~first & ((delta < epsilon) | hit)
        # freeze recordings that converged on a PREVIOUS iteration; the
        # iteration that crosses the threshold keeps its update
        keep = st["converged"]

        def sel(old, new):
            return torch.where(keep.view(-1, *[1] * (old.dim() - 1)),
                               old, new)

        elbo = st["elbo"].clone()
        elbo[:, it] = torch.where(keep, elbo[:, it], elbo_val)
        return dict(
            converged=keep | now_conv,
            n_iters=st["n_iters"] + (~keep).to(torch.int32),
            gamma=sel(st["gamma"], fbr.gamma), pi=sel(st["pi"], new_pi),
            elbo=elbo, last_elbo=sel(st["last_elbo"], elbo_val),
            plateau=sel(st["plateau"], new_plateau),
            alpha=sel(st["alpha"], alpha), invL=sel(st["invL"], invL))

    S = gamma.shape[-1]
    init = dict(
        converged=converged0.to(torch.bool),
        n_iters=torch.zeros((B,), dtype=torch.int32, device=dev),
        gamma=gamma, pi=pi,
        elbo=torch.full((B, max_iters), math.nan, dtype=dtype, device=dev),
        last_elbo=last_elbo0.to(dtype), plateau=plateau0.to(torch.int32),
        alpha=(alpha0 if has_initial_model
               else torch.zeros((B, S, D), dtype=dtype, device=dev)),
        invL=(invL0 if has_initial_model
              else torch.ones((B, S, D), dtype=dtype, device=dev)))
    fin = _run_em(step, init, max_iters)
    return VBxResult(fin["gamma"], fin["pi"], fin["elbo"], fin["n_iters"],
                     fin["alpha"], fin["invL"])


def _em_kernel(X, phi, gamma, pi, frame_mask, speaker_mask, loop_prob, fa,
               fb, epsilon, converged0, last_elbo0, plateau_ulps,
               plateau_iters, plateau0, *, max_iters: int,
               io_dtype: torch.dtype) -> VBxResult:
    """Batched EM around the fused forward-backward kernel (the counterpart
    of vbx_tpu's `_vbx_batched_pallas_sb_jit`). Everything stays in the
    kernel's [B, T, S] layout. io_dtype=bfloat16 stores the large streams —
    rho, the gamma loop state, w and the kernel's ahat/bhat — in bfloat16;
    every product and reduction accumulates in float32: bfloat16 operands
    are upcast before each matmul (their products are exact in float32, as
    with vbx_tpu's preferred_element_type=f32), and the normalizers, ELBO
    and pi updates never leave float32."""
    f32 = torch.float32
    dev = X.device
    B, T, D = X.shape
    X = X.to(f32)
    phi = phi.to(f32)

    def scalar(v):
        return torch.as_tensor(v, dtype=f32, device=dev)

    lp, fa, fb, epsilon = map(scalar, (loop_prob, fa, fb, epsilon))
    plateau_ulps = scalar(plateau_ulps)
    eps_machine = scalar(torch.finfo(f32).eps)
    eps = scalar(1e-8)
    tiny = torch.finfo(f32).tiny
    smask = speaker_mask.to(torch.bool)
    smask_f = speaker_mask.to(f32)
    fmask = frame_mask.to(f32)                                     # [B, T]
    valid_tb = fmask.T                                             # [T, B]
    not_first = fmask.clone()
    not_first[:, 0] = 0.0

    G_bt = -0.5 * ((X * X).sum(-1)
                   + D * scalar(math.log(2 * math.pi)))            # [B, T]
    # float32 values of the stream-typed rho (bfloat16 values are exact
    # in float32, so the products below see what vbx_tpu's bf16 MXU sees)
    rho = (X * torch.sqrt(phi)).to(io_dtype).to(f32)               # [B,T,D]
    fa_over_fb = fa / fb

    g = (gamma.to(f32) * fmask[:, :, None]
         * smask_f[:, None, :]).to(io_dtype)                       # [B,T,S]
    pi = pi.to(f32) * smask_f
    fresh = last_elbo0 == scalar(NEG_INF)

    def m_step(g, counts):
        # counts come pre-accumulated (f32) from the combine step; only the
        # cross-stats product still reads the gamma stream
        invL = 1.0 / (1.0 + fa_over_fb * counts[:, :, None] * phi)
        stats = torch.matmul(g.to(f32).transpose(1, 2), rho)       # [B,S,D]
        return invL, fa_over_fb * invL * stats

    def step(st, it):
        first = fresh & (it == 0)
        invL, alpha = m_step(st["gamma"], st["counts"])
        # the E-step product is stored at the stream type, as in vbx_tpu
        cross = torch.matmul(rho, alpha.to(io_dtype).to(f32)
                             .transpose(1, 2)).to(io_dtype)        # [B,T,S]
        quad = torch.matmul(invL + alpha * alpha, phi)             # [B, S]
        log_p = fa * (cross.to(f32) - 0.5 * quad[:, None, :]
                      + G_bt[:, :, None])
        log_p = masked_fill(log_p, smask[:, None, :])
        col = (1.0 - lp) * st["pi"] + eps
        pinit = st["pi"] + eps
        ahat, bhat, cfw, m, w = fb_scan_sb_logp_bts(
            log_p, smask_f, valid_tb, col.T, pinit.T, loop_prob,
            recip=True, io_dtype=io_dtype)
        # back to the kernel's [B, T, S] buffers (views, no copies)
        ahat, bhat, w = (x.permute(2, 0, 1) for x in (ahat, bhat, w))
        cfw, m = cfw.T, m.T                                        # [B, T]
        bh = bhat.to(f32)
        ab = ahat.to(f32) * bh
        denom = torch.clamp(ab.sum(-1, keepdim=True), min=tiny)
        gn = (ab / denom) * fmask[:, :, None]
        keep = st["converged"]
        # convergence freezing inside the gamma producer
        g_next = torch.where(keep[:, None, None], st["gamma"],
                             gn.to(io_dtype))
        new_counts = g_next.to(f32).sum(1)                         # [B, S]
        log_px = (fmask * (m + torch.log(cfw))).sum(1)
        terms = w.to(f32) * bh / (denom * cfw[:, :, None])
        pi_stat = (terms * not_first[:, :, None]).sum(1)           # [B, S]
        elbo_val = log_px + vb_elbo_model_term(invL, alpha, fb)
        new_pi = vb_pi_update(g_next[:, 0].to(f32), st["pi"], pi_stat, lp)
        delta = elbo_val - st["last_elbo"]
        new_plateau, hit = _plateau_step(delta, elbo_val, st["plateau"],
                                         plateau_ulps, plateau_iters,
                                         eps_machine)
        now_conv = ~first & ((delta < epsilon) | hit)
        # a frozen lane's column `it` was never written: one NaN-masked
        # write replaces a whole-trace select
        elbo = st["elbo"]
        elbo[:, it] = torch.where(keep, scalar(math.nan), elbo_val)
        return dict(
            converged=keep | now_conv, gamma=g_next, counts=new_counts,
            pi=torch.where(keep[:, None], st["pi"], new_pi), elbo=elbo,
            last_elbo=torch.where(keep, st["last_elbo"], elbo_val),
            plateau=torch.where(keep, st["plateau"], new_plateau))

    init = dict(
        converged=converged0.to(torch.bool), gamma=g,
        counts=g.to(f32).sum(1), pi=pi,
        elbo=torch.full((B, max_iters), math.nan, dtype=f32, device=dev),
        last_elbo=last_elbo0.to(f32), plateau=plateau0.to(torch.int32))
    fin = _run_em(step, init, max_iters)
    n_iters = (~torch.isnan(fin["elbo"])).sum(1).to(torch.int32)
    # speaker model recomputed from the FINAL responsibilities (one extra
    # M-step), as vbx_tpu's kernel route does
    invL_f, alpha_f = m_step(fin["gamma"], fin["counts"])
    return VBxResult(fin["gamma"].to(f32), fin["pi"], fin["elbo"], n_iters,
                     alpha_f, invL_f)


def _dirichlet_gamma(shape, alpha_q_init: float, rng: torch.Generator,
                     dtype, device) -> torch.Tensor:
    """Flat-Dirichlet responsibilities from `rng` (Marsaglia-Tsang gamma
    draws, normalized per frame). torch's own gamma sampler takes no
    generator."""
    a = float(alpha_q_init)
    boost = a < 1.0                 # gamma(a) = gamma(a + 1) * U^(1/a)
    d = (a + 1.0 if boost else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(shape, dtype=torch.float64)
    todo = torch.ones(shape, dtype=torch.bool)
    while todo.any():
        x = torch.randn(shape, generator=rng, dtype=torch.float64)
        u = torch.rand(shape, generator=rng, dtype=torch.float64)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-300)))
        take = todo & ok
        out[take] = (d * v)[take]
        todo &= ~take
    if boost:
        u = torch.rand(shape, generator=rng, dtype=torch.float64)
        out = out * u ** (1.0 / a)
    g = out / out.sum(-1, keepdim=True)
    return g.to(dtype=dtype, device=device)


def vbx(
    X,
    phi,
    loop_prob: float = 0.9,
    Fa: float = 1.0,
    Fb: float = 1.0,
    pi=10,
    gamma=None,
    max_iters: int = 10,
    epsilon: float = 1e-4,
    alpha_q_init: float = 1.0,
    rng: Optional[torch.Generator] = None,
    frame_mask=None,
    speaker_mask=None,
    alpha=None,
    invL=None,
    fb_impl: str = "structured",
    dtype=None,
    plateau_ulps: float = 0.0,
    plateau_iters: int = 2,
    device=None,
) -> VBxResult:
    """Single-recording VB-HMM (API parity with reference VBx.VBx:27-126).

    X:       [T, D] PLDA-space features (tensor or array).
    phi:     [D] across-class covariance diagonal.
    pi:      int S (max speakers, uniform prior) or [S] prior vector.
    gamma:   [T, S] initial responsibilities; if None, sampled from a flat
             Dirichlet with concentration alpha_q_init (requires rng, a
             torch.Generator on the CPU).
    alpha/invL: an initial speaker model; iteration 0 uses it instead of
             the M-step (VBx.py:94).
    device:  'cuda' unless the caller passes 'cpu' (device.resolve_device).
    """
    if fb_impl not in _FB_IMPLS:
        raise ValueError(
            f"vbx() supports fb_impl in {sorted(_FB_IMPLS)}; the fused "
            f"'pallas' path is batched-only (use vbx_batched), got "
            f"{fb_impl!r}")
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    dtype = dtype or X.dtype
    X = X.to(dtype)
    phi = torch.as_tensor(phi, device=dev).to(dtype)
    T, D = X.shape
    if isinstance(pi, (int, np.integer)):
        pi = torch.ones((int(pi),), dtype=dtype, device=dev) / int(pi)
    else:
        pi = torch.as_tensor(pi, device=dev).to(dtype)
    S = pi.shape[0]
    if gamma is None:
        if rng is None:
            raise ValueError("gamma=None requires an rng (torch.Generator) "
                             "for the Dirichlet initialization")
        gamma = _dirichlet_gamma((T, S), alpha_q_init, rng, dtype, dev)
    else:
        gamma = torch.as_tensor(gamma, device=dev).to(dtype)
    if tuple(gamma.shape) != (T, S):
        raise ValueError(f"gamma shape {tuple(gamma.shape)} != {(T, S)}")
    frame_mask = (torch.ones((T,), dtype=torch.bool, device=dev)
                  if frame_mask is None
                  else torch.as_tensor(frame_mask, device=dev).to(torch.bool))
    speaker_mask = (torch.ones((S,), dtype=torch.bool, device=dev)
                    if speaker_mask is None
                    else torch.as_tensor(speaker_mask, device=dev)
                    .to(torch.bool))
    has_model = alpha is not None and invL is not None
    alpha0 = (torch.as_tensor(alpha, device=dev).to(dtype)[None]
              if has_model else None)
    invL0 = (torch.as_tensor(invL, device=dev).to(dtype)[None]
             if has_model else None)
    with full_fp32_matmuls():
        res = _em_structured(
            X[None], phi, gamma[None], pi[None], frame_mask[None],
            speaker_mask[None], loop_prob, Fa, Fb, epsilon, alpha0, invL0,
            torch.zeros((1,), dtype=torch.bool, device=dev),
            torch.full((1,), NEG_INF, dtype=dtype, device=dev),
            plateau_ulps, plateau_iters,
            torch.zeros((1,), dtype=torch.int32, device=dev),
            max_iters=max_iters, has_initial_model=has_model,
            fb_impl=fb_impl)
    return VBxResult(*(x[0] for x in res))


def _over_kernel_capacity(fb_impl: str, S: int, dev: torch.device,
                          cap: int = S_MAX,
                          kernel: str = "fused kernel") -> str:
    """The kernel route asked for more than its kernel's `cap` speakers
    (S_MAX for the fused kernel). On a card that raises: a card never
    leaves the kernel route. On the CPU, where the route runs the kernel's
    plain twin anyway, the engine falls back to 'structured' with a
    UserWarning, as vbx_tpu does past its kernel's 256 (the reference loop
    has no S limit, VBx.py:97-98)."""
    msg = (f"fb_impl={fb_impl!r} supports at most {cap} speakers (the "
           f"{kernel}'s per-lane capacity); got S={S}")
    if dev.type != "cpu":
        raise ValueError(f"{msg}; on {dev} use fb_impl='structured'")
    warnings.warn(f"{msg} — falling back to fb_impl='structured'",
                  stacklevel=3)
    return "structured"


def vbx_batched(
    X,                 # [B, T, D] padded features
    phi,               # [D]
    gamma,             # [B, T, S] padded initial responsibilities
    pi,                # [B, S] padded initial priors
    frame_mask,        # [B, T] bool
    speaker_mask,      # [B, S] bool
    loop_prob: float,
    Fa: float,
    Fb: float,
    max_iters: int = 40,
    epsilon: float = 1e-6,
    fb_impl: Optional[str] = None,
    converged0=None,   # [B] resume: already-done mask
    last_elbo0=None,   # [B] resume: carried ELBO
    plateau_ulps: float = 0.0,
    plateau_iters: int = 2,
    plateau0=None,     # [B] resume: carried plateau counter
    device=None,
) -> VBxResult:
    """Batched VB-HMM over padded recordings with per-recording convergence.

    fb_impl: None/'structured' (default — the sequential smoother at X's
    dtype, float64 included; a recording's result equals its solo run),
    'pallas' (float32 EM around the fused CUDA forward-backward kernel),
    'pallas_bf16' (the same kernel route with the large per-iteration
    streams stored in bfloat16 — float32 accumulation throughout,
    tolerance-parity only) or 'assoc' (the work-parallel associative-scan
    smoother at X's dtype). The kernel holds at most S_MAX = 4096
    speakers (vbx_tpu's held 256); past that the kernel route raises on a
    card and falls back to 'structured' with a UserWarning on the CPU
    (_over_kernel_capacity). A failed kernel build or launch raises: there
    is no quiet fallback.

    converged0/last_elbo0/plateau0 resume a run mid-trajectory: a resumed
    lane's first iteration may converge against the carried ELBO, and
    already-converged lanes stay frozen from iteration 0.
    plateau_ulps/plateau_iters: opt-in f32 plateau stop (_plateau_step).
    device: 'cuda' unless the caller passes 'cpu'.
    """
    dev = resolve_device(device)

    def put(x, dtype=None):
        t = torch.as_tensor(x, device=dev)
        return t if dtype is None else t.to(dtype)

    X = put(X)
    gamma = put(gamma)
    B, S = gamma.shape[0], gamma.shape[-1]
    fb_impl = fb_impl or "structured"
    if fb_impl not in (*_FB_IMPLS, *_KERNEL_IMPLS):
        raise ValueError(f"unknown fb_impl={fb_impl!r}; use one of "
                         f"{sorted((*_FB_IMPLS, *_KERNEL_IMPLS))}")
    if fb_impl in _KERNEL_IMPLS and S > S_MAX:
        fb_impl = _over_kernel_capacity(fb_impl, S, dev)
    kernel = fb_impl in _KERNEL_IMPLS
    dtype = torch.float32 if kernel else X.dtype
    converged0 = (torch.zeros((B,), dtype=torch.bool, device=dev)
                  if converged0 is None else put(converged0, torch.bool))
    plateau0 = (torch.zeros((B,), dtype=torch.int32, device=dev)
                if plateau0 is None else put(plateau0, torch.int32))
    # the fresh-start sentinel is created in the ENGINE dtype: NEG_INF is
    # not float32-representable exactly, so an f32 sentinel upcast into an
    # f64 engine would no longer compare equal and every lane would look
    # resumed
    last_elbo0 = (torch.full((B,), NEG_INF, dtype=dtype, device=dev)
                  if last_elbo0 is None else put(last_elbo0, dtype))
    args = (put(phi, dtype), gamma.to(dtype), put(pi, dtype),
            put(frame_mask, torch.bool), put(speaker_mask, torch.bool),
            loop_prob, Fa, Fb, epsilon)
    with full_fp32_matmuls():
        if kernel:
            return _em_kernel(
                X, *args, converged0, last_elbo0, plateau_ulps,
                plateau_iters, plateau0, max_iters=max_iters,
                io_dtype=_KERNEL_IMPLS[fb_impl])
        return _em_structured(
            X, *args, None, None, converged0, last_elbo0, plateau_ulps,
            plateau_iters, plateau0, max_iters=max_iters,
            has_initial_model=False, fb_impl=fb_impl)


def vbx_batched_checkpointed(
    X,
    phi,
    gamma,
    pi,
    frame_mask,
    speaker_mask,
    loop_prob: float,
    Fa: float,
    Fb: float,
    max_iters: int = 40,
    epsilon: float = 1e-6,
    fb_impl: Optional[str] = None,
    iters_per_slice: int = 10,
    checkpoint_path: Optional[str] = None,
    mesh=None,
    plateau_ulps: float = 0.0,
    plateau_iters: int = 2,
    device=None,
) -> VBxResult:
    """vbx_batched with mid-EM engine-state checkpointing (the reference's
    only durability is whole files per recording; a preempted long batch
    here resumes mid-recording).

    `mesh`: a ('dp', 'sp') parallel.Mesh runs every slice through the
    sharded engine (parallel.vbx_sharded): a preempted slice of hour-long
    frame-sharded meetings resumes exactly. Under a mesh
    fb_impl='pallas'/'pallas_bf16' selects the kernel blockwise smoother
    (tolerance-parity); anything else runs the structured blockwise
    smoother. The run's tensors then live on the mesh's devices and
    `device` is ignored.

    The EM runs in host-visible slices of `iters_per_slice` iterations.
    After each slice the full loop state — (gamma, pi, converged,
    last_elbo, plateau counter, stitched ELBO trace) — is on the host and,
    if `checkpoint_path` is given, written atomically (tmp + rename). A
    rerun with the same arguments loads the file and continues from the
    last completed slice; the file is removed on successful completion.
    The file format is vbx_tpu's, key for key (header strings and dtypes
    included), so a file written by either package resumes in the other.

    Slicing is EXACT, not approximate: the loop state is externalized
    (vbx_batched's converged0/last_elbo0/plateau0), so a sliced run follows
    the same trajectory as one long run, bit-identical at a fixed padded
    shape (tests/test_torch_checkpoint.py).

    vbx_tpu restarts a checkpointed run on the structured engine when its
    kernel fails to compile at 128 < S <= 256. That has no counterpart
    here: on a card a kernel build or launch failure raises, as in
    vbx_batched.
    """
    if iters_per_slice < 1:
        raise ValueError(f"iters_per_slice must be >= 1, got "
                         f"{iters_per_slice}")
    dev = mesh.first_device if mesh is not None else resolve_device(device)
    X = torch.as_tensor(X, device=dev)      # moved once, not once per slice
    gamma = torch.as_tensor(gamma)
    B, T, S = gamma.shape
    x_dt = np.dtype(str(X.dtype).replace("torch.", ""))
    if (fb_impl or "").startswith("pallas"):
        # past the kernels' capacity a card raises and the CPU falls back
        # to 'structured' (_over_kernel_capacity). Resolve that ONCE, before
        # committing to the kernel route's float32 state dtype and a
        # '+pallas' checkpoint header: they would quantize a float64
        # structured trajectory's deltas and misdescribe the run.
        if mesh is not None:
            from vbx_tpu_torch.ops.fb_product_kernel import S_MAX as s_cap
            kernel_name = "operator-product kernel"
        else:
            s_cap, kernel_name = S_MAX, "fused kernel"
        if S > s_cap:
            _over_kernel_capacity(fb_impl, S, dev, cap=s_cap,
                                  kernel=kernel_name)
            fb_impl = None
    # carry the loop state in the ENGINE dtype: the kernel routes run f32
    # regardless of input, the structured route runs in X's dtype — an f32
    # downcast there would quantize sub-f32 ELBO deltas to zero and flag
    # convergence early
    fb = fb_impl or "structured"
    mesh_pallas = mesh is not None and fb in _KERNEL_IMPLS
    if mesh is not None:
        fb = (f"sharded[{','.join(f'{k}={v}' for k, v in mesh.shape.items())}]"
              + (f"+{fb_impl}" if mesh_pallas else ""))
        dt = np.dtype(np.float32) if mesh_pallas else x_dt
    else:
        dt = np.dtype(np.float32) if fb.startswith("pallas") else x_dt
    it_done = 0
    elbo_full = np.full((B, max_iters), np.nan, dt)
    converged = np.zeros((B,), bool)
    last_elbo = np.full((B,), NEG_INF, dt)
    plateau = np.zeros((B,), np.int32)
    g_cur = gamma
    pi_cur = torch.as_tensor(pi)

    # the hyperparameters that define the trajectory: a checkpoint from a
    # differently-configured run must not silently resume
    header = {"shape": np.array([B, T, S]), "fb_impl": np.str_(fb),
              "dtype": np.str_(dt.name),
              "hp": np.array([float(loop_prob), float(Fa), float(Fb),
                              float(epsilon), float(max_iters),
                              float(plateau_ulps), float(plateau_iters)])}

    if checkpoint_path and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as ck:
            for key, want in header.items():
                got = ck[key] if key in ck.files else None
                if (key == "hp" and got is not None
                        and np.asarray(got).shape == (5,)
                        and plateau_ulps == 0.0 and plateau_iters == 2):
                    # early checkpoints carried a 5-element hp (no plateau
                    # fields) and no 'plateau' array; they resume under the
                    # implied defaults (plateau off) rather than forcing a
                    # preempted long run back to iteration 0
                    want = np.asarray(want)[:5]
                if got is None or np.asarray(got).shape != np.asarray(
                        want).shape or not np.all(np.asarray(got) == want):
                    raise ValueError(
                        f"checkpoint {checkpoint_path} was written by a "
                        f"differently-configured run ({key}: {got!r} != "
                        f"{want!r}); delete it or use a distinct path")
            it_done = int(ck["it_done"])
            elbo_full[:, :it_done] = ck["elbo"][:, :it_done]
            converged = ck["converged"]
            last_elbo = ck["last_elbo"].astype(dt)
            plateau = (ck["plateau"].astype(np.int32)
                       if "plateau" in ck.files
                       else np.zeros((B,), np.int32))
            g_cur = torch.from_numpy(ck["gamma"])
            pi_cur = torch.from_numpy(ck["pi"])

    while it_done < max_iters and not converged.all():
        k = min(iters_per_slice, max_iters - it_done)
        resume = dict(converged0=torch.from_numpy(converged),
                      last_elbo0=torch.from_numpy(last_elbo),
                      plateau_ulps=plateau_ulps, plateau_iters=plateau_iters,
                      plateau0=torch.from_numpy(plateau))
        if mesh is not None:
            from vbx_tpu_torch.parallel.engine import vbx_sharded
            res = vbx_sharded(
                mesh, X, phi, g_cur, pi_cur, frame_mask, speaker_mask,
                loop_prob=loop_prob, Fa=Fa, Fb=Fb, max_iters=k,
                epsilon=epsilon, fb_impl=(fb_impl if mesh_pallas else None),
                **resume)
        else:
            res = vbx_batched(
                X, phi, g_cur, pi_cur, frame_mask, speaker_mask, loop_prob,
                Fa, Fb, max_iters=k, epsilon=epsilon, fb_impl=fb_impl,
                device=dev, **resume)
        g_cur, pi_cur = res.gamma, res.pi
        elbo_k = res.elbo.cpu().numpy().astype(dt, copy=False)   # [B, k]
        n_k = np.sum(~np.isnan(elbo_k), axis=1)            # per-rec iters
        elbo_full[:, it_done:it_done + k] = elbo_k
        ran = n_k > 0
        idx = np.arange(B)
        new_last = elbo_k[idx, np.maximum(n_k - 1, 0)]
        # the engine freezes a recording on the iteration AFTER its
        # crossing delta, so convergence exactly equals "the last recorded
        # delta is below epsilon" — recompute it on host (same engine-dtype
        # values the device compared) because a recording that crosses on
        # the slice's final iteration is otherwise indistinguishable from
        # one still running (n_k == k either way)
        prev_of_last = np.where(
            n_k >= 2, elbo_k[idx, np.maximum(n_k - 2, 0)], last_elbo)
        last_delta = new_last - prev_of_last               # engine dtype
        converged_new = (ran & (n_k < k)) \
            | (ran & (last_delta < dt.type(epsilon)))
        if plateau_ulps > 0:
            # replay the engine's counter over this slice's recorded
            # deltas (same engine-dtype values, same operation grouping as
            # _plateau_step) — needed for the same reason as last_delta: a
            # lane whose plateau fires on the slice's final iteration has
            # n_k == k, and the counter must carry into the next slice
            was_conv = converged
            c = plateau.copy()
            prev = last_elbo.copy()
            eps_m = dt.type(np.finfo(dt).eps)
            pu = dt.type(plateau_ulps)
            for j in range(k):
                active = (~was_conv) & (n_k > j)
                cur = elbo_k[:, j]
                quantum = eps_m * np.maximum(np.abs(cur), dt.type(1.0))
                small = np.abs((cur - prev).astype(dt)) <= pu * quantum
                c = np.where(active, np.where(small, c + 1, 0), c)
                prev = np.where(active, cur, prev)
            plateau = c.astype(np.int32)
            converged_new |= ran & (plateau >= plateau_iters)
        converged = converged | converged_new
        last_elbo = np.where(ran, new_last, last_elbo)
        it_done += k
        if checkpoint_path:
            tmp = checkpoint_path + ".tmp.npz"   # .npz: savez won't rename
            np.savez(tmp, gamma=g_cur.cpu().numpy(),
                     pi=pi_cur.cpu().numpy(), converged=converged,
                     last_elbo=last_elbo, plateau=plateau,
                     elbo=elbo_full, it_done=it_done,
                     **header)
            os.replace(tmp, checkpoint_path)

    if checkpoint_path and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)

    n_iters = np.sum(~np.isnan(elbo_full), axis=1).astype(np.int32)

    # final speaker model recomputed from the FINAL responsibilities (the
    # kernel route's convention): a recording frozen in an earlier slice
    # would otherwise surface that slice's — or no — model. Both this and
    # the crossing-iteration model are valid converged models and agree to
    # within the convergence tolerance.
    phi = torch.as_tensor(phi, device=dev).to(X.dtype)
    g_cur = g_cur.to(dev)
    with full_fp32_matmuls():
        _, rho = vb_precompute(X, phi)
        invL_f, alpha_f = vb_m_step(g_cur.to(X.dtype), rho, phi, Fa / Fb)
    return VBxResult(g_cur, pi_cur.to(dev),
                     torch.from_numpy(elbo_full).to(dev),
                     torch.from_numpy(n_iters).to(dev), alpha_f, invL_f)
