"""Sharded VB-HMM engine: recordings x frames over a ('dp', 'sp') mesh
(port of vbx_tpu.parallel.engine).

The EM loop of engine.vbhmm, distributed:
- recordings split over 'dp' rows (independent, no communication between
  rows, like the reference's per-recording process fan-out),
- frames split over the 'sp' shards of a row, with psum'd M-step
  sufficient statistics (sum_t gamma and gamma^T rho, the reductions at
  VBx/VBx.py:95-96) and the blockwise boundary-exchange smoother
  (parallel.fb_blockwise),
- per-recording convergence freezing as in the single-device engine. All
  shards of a row compute the same psum'd ELBO, so they stop together.

vbx_tpu runs one program per device under shard_map and vmap over
recordings. Here one process drives every shard: lanes are a batch
dimension, the host drives the loop (engine.vbhmm._run_em, with its check
every CHECK_EVERY iterations), and every collective goes through the
mesh's psum / all_gather. Each shard keeps its own copy of the replicated
state (priors, counts, ELBO), as each device does under shard_map.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch

from vbx_tpu_torch.device import full_fp32_matmuls
from vbx_tpu_torch.engine.vbhmm import (_KERNEL_IMPLS, _over_kernel_capacity,
                                        _plateau_step, _run_em)
from vbx_tpu_torch.ops.fb_product_kernel import S_MAX as K2_S_MAX
from vbx_tpu_torch.ops.lse import NEG_INF, masked_fill
from vbx_tpu_torch.ops.vb_steps import (vb_elbo_model_term,
                                        vb_log_likelihoods, vb_pi_update,
                                        vb_precompute)
from vbx_tpu_torch.parallel.fb_blockwise import (
    forward_backward_blockwise, forward_backward_blockwise_kernel)
from vbx_tpu_torch.parallel.mesh import Mesh


class ShardedVBxResult(NamedTuple):
    gamma: torch.Tensor    # [B, T, S] on the mesh's first device
    pi: torch.Tensor       # [B, S]
    elbo: torch.Tensor     # [B, max_iters] (NaN past convergence)
    n_iters: torch.Tensor  # [B] int32


def _consts(dev, dtype, ln: dict, loop_prob, Fa, Fb, epsilon,
            plateau_ulps, plateau_iters) -> dict:
    """Per-shard constants of the EM (scalars on the shard's device)."""
    def scalar(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    fa, fb = scalar(Fa), scalar(Fb)
    return dict(loop_prob=float(loop_prob), lp=scalar(loop_prob),
                fa=fa, fb=fb, fa_over_fb=fa / fb, epsilon=scalar(epsilon),
                plateau_ulps=scalar(plateau_ulps),
                plateau_iters=plateau_iters,
                eps_machine=scalar(torch.finfo(dtype).eps),
                log2pi=scalar(math.log(2 * math.pi)), nan=scalar(math.nan),
                fresh=ln["last_elbo0"] == scalar(NEG_INF))


def _stop_rule(sh: dict, c: dict, elbo_val, it: int) -> dict:
    """The per-lane stop rule of both routes (Delta-ELBO < epsilon or the
    opt-in plateau; never on a fresh lane's first iteration): the new
    converged flags, ELBO trace, last ELBO and plateau counters. Lanes
    that converged on an earlier iteration stay frozen, and their ELBO
    column stays NaN."""
    keep = sh["converged"]
    first = c["fresh"] & (it == 0)
    delta = elbo_val - sh["last_elbo"]
    new_plateau, hit = _plateau_step(delta, elbo_val, sh["plateau"],
                                     c["plateau_ulps"], c["plateau_iters"],
                                     c["eps_machine"])
    now_conv = ~first & ((delta < c["epsilon"]) | hit)
    elbo = sh["elbo"]
    elbo[:, it] = torch.where(keep, c["nan"], elbo_val)
    return dict(converged=keep | now_conv, elbo=elbo,
                last_elbo=torch.where(keep, sh["last_elbo"], elbo_val),
                plateau=torch.where(keep, sh["plateau"], new_plateau))


def _structured_row(mesh: Mesh, lanes: List[dict], cfg: dict,
                    max_iters: int):
    """Shards of one dp row through the structured EM (vbx_tpu's
    `_vb_em_sharded_single` under vmap): the blockwise plain-torch
    smoother at the input dtype. Returns (step, initial per-shard
    states) for _run_mesh."""
    row = []
    for ln in lanes:
        X = ln["X"]
        dtype = X.dtype
        c = _consts(X.device, dtype, ln, **cfg)
        c["phi"] = ln["phi"]
        c["G"], c["rho"] = vb_precompute(X, ln["phi"])
        c["fmask"] = ln["frame_mask"]
        c["smask"] = ln["speaker_mask"]
        fm, sm = c["fmask"].to(dtype), c["smask"].to(dtype)
        B = X.shape[0]
        row.append(dict(
            c=c, converged=ln["converged0"],
            n_iters=torch.zeros((B,), dtype=torch.int32, device=X.device),
            gamma=ln["gamma"] * fm[:, :, None] * sm[:, None, :],
            pi=ln["pi"] * sm,
            elbo=torch.full((B, max_iters), math.nan, dtype=dtype,
                            device=X.device),
            last_elbo=ln["last_elbo0"], plateau=ln["plateau0"]))

    def step(row, it):
        cs = [sh["c"] for sh in row]
        # M-step with cross-shard frame reductions (VBx.py:95-96 -> psum)
        counts = mesh.psum([sh["gamma"].sum(1) for sh in row])
        stats = mesh.psum([torch.matmul(sh["gamma"].transpose(1, 2),
                                        c["rho"]) for sh, c in zip(row, cs)])
        invL = [1.0 / (1.0 + c["fa_over_fb"] * n[:, :, None] * c["phi"])
                for c, n in zip(cs, counts)]
        alpha = [c["fa_over_fb"] * iL * s for c, iL, s in
                 zip(cs, invL, stats)]
        log_p = [masked_fill(vb_log_likelihoods(c["rho"], c["G"], iL, a,
                                                c["phi"], c["fa"]),
                             c["smask"][:, None, :])
                 for c, iL, a in zip(cs, invL, alpha)]
        fbr = forward_backward_blockwise(
            log_p, [sh["pi"] for sh in row], cs[0]["loop_prob"], mesh,
            frame_mask=[c["fmask"] for c in cs])
        new = []
        for sh, c, iL, a, r in zip(row, cs, invL, alpha, fbr):
            elbo_val = r.log_px + vb_elbo_model_term(iL, a, c["fb"])
            new_pi = vb_pi_update(r.gamma0, sh["pi"], r.pi_stat, c["lp"])
            keep = sh["converged"]
            new.append(dict(
                c=c, **_stop_rule(sh, c, elbo_val, it),
                n_iters=sh["n_iters"] + (~keep).to(torch.int32),
                gamma=torch.where(keep[:, None, None], sh["gamma"], r.gamma),
                pi=torch.where(keep[:, None], sh["pi"], new_pi)))
        return new

    return step, row


def _kernel_row(mesh: Mesh, lanes: List[dict], cfg: dict, max_iters: int,
                io_dtype: torch.dtype):
    """Shards of one dp row through the kernel-route EM (vbx_tpu's
    `_vb_em_sharded_batched_pallas`, written like the port's single-device
    `engine.vbhmm._em_kernel`): float32 EM, K2 + K1 smoother, streams at
    io_dtype. bfloat16 operands are upcast before each matmul (their
    products are exact in float32) and the normalizers, ELBO and priors
    never leave float32. Returns (step, initial per-shard states) for
    _run_mesh."""
    f32 = torch.float32
    row = []
    for ln in lanes:
        X = ln["X"].to(f32)
        dev = X.device
        B, T, D = X.shape
        c = _consts(dev, f32, ln, **cfg)
        phi = ln["phi"].to(f32)
        c["phi"] = phi
        c["smask"] = ln["speaker_mask"]
        smask_f = ln["speaker_mask"].to(f32)
        fmask = ln["frame_mask"].to(f32)                          # [B, T]
        c["valid_tb"] = ln["frame_mask"].T                        # [T, B]
        c["G"] = -0.5 * ((X * X).sum(-1) + D * c["log2pi"])       # [B, T]
        # float32 values of the stream-typed rho
        c["rho"] = (X * torch.sqrt(phi)).to(io_dtype).to(f32)
        g = (ln["gamma"].to(f32) * fmask[:, :, None]
             * smask_f[:, None, :]).to(io_dtype)
        row.append(dict(
            c=c, converged=ln["converged0"], gamma=g,
            pi=ln["pi"].to(f32) * smask_f,
            elbo=torch.full((B, max_iters), math.nan, dtype=f32, device=dev),
            last_elbo=ln["last_elbo0"], plateau=ln["plateau0"]))
    counts0 = mesh.psum([sh["gamma"].to(f32).sum(1) for sh in row])
    for sh, n in zip(row, counts0):
        sh["counts"] = n

    def step(row, it):
        cs = [sh["c"] for sh in row]
        invL = [1.0 / (1.0 + c["fa_over_fb"] * sh["counts"][:, :, None]
                       * c["phi"]) for sh, c in zip(row, cs)]
        stats = mesh.psum([torch.matmul(sh["gamma"].to(f32).transpose(1, 2),
                                        c["rho"]) for sh, c in zip(row, cs)])
        alpha = [c["fa_over_fb"] * iL * s for c, iL, s in
                 zip(cs, invL, stats)]
        log_p = []
        for c, iL, a in zip(cs, invL, alpha):
            # the E-step product is stored at the stream type, as in vbx_tpu
            cross = torch.matmul(c["rho"], a.to(io_dtype).to(f32)
                                 .transpose(1, 2)).to(io_dtype)
            quad = torch.matmul(iL + a * a, c["phi"])             # [B, S]
            lpk = c["fa"] * (cross.to(f32) - 0.5 * quad[:, None, :]
                             + c["G"][:, :, None])
            log_p.append(masked_fill(lpk, c["smask"][:, None, :]))
        fbr = forward_backward_blockwise_kernel(
            log_p, [sh["pi"] for sh in row], cs[0]["loop_prob"], mesh,
            frame_mask=[c["valid_tb"] for c in cs],
            speaker_mask=[c["smask"] for c in cs], recip=True,
            io_dtype=io_dtype)
        # freeze-select in the gamma producer; counts from the SELECTED
        # gamma (frozen lanes re-reduce the same values)
        g_next = [torch.where(sh["converged"][:, None, None], sh["gamma"],
                              r.gamma.permute(2, 0, 1).to(io_dtype))
                  for sh, r in zip(row, fbr)]
        counts = mesh.psum([g.to(f32).sum(1) for g in g_next])
        new = []
        for sh, c, iL, a, r, g, n in zip(row, cs, invL, alpha, fbr, g_next,
                                         counts):
            elbo_val = r.log_px + vb_elbo_model_term(iL, a, c["fb"])
            new_pi = vb_pi_update(r.gamma0.T, sh["pi"], r.pi_stat.T, c["lp"])
            new.append(dict(
                c=c, **_stop_rule(sh, c, elbo_val, it), gamma=g, counts=n,
                pi=torch.where(sh["converged"][:, None], sh["pi"], new_pi)))
        return new

    return step, row


def _run_mesh(mesh: Mesh, rows, max_iters: int):
    """Drive every dp row's EM in lockstep through engine.vbhmm._run_em:
    it stops once every lane of the mesh has converged (read from shard 0
    of each row; a row's shards hold the same flags). A row whose lanes
    have all converged keeps stepping with every lane frozen, which
    changes nothing."""
    dev0 = mesh.first_device

    def flags(states):
        return torch.cat([st[0]["converged"].to(dev0) for st in states])

    def step(state, it):
        states = [fn(st, it) for fn, st in zip(state["steps"],
                                              state["rows"])]
        return dict(steps=state["steps"], rows=states,
                    converged=flags(states))

    steps, states = zip(*rows)
    fin = _run_em(step, dict(steps=steps, rows=list(states),
                             converged=flags(states)), max_iters)
    return fin["rows"]


def vbx_sharded(
    mesh: Mesh,
    X,                   # [B, T, D]
    phi,                 # [D]
    gamma,               # [B, T, S]
    pi,                  # [B, S]
    frame_mask,          # [B, T] bool (padding must be a suffix)
    speaker_mask,        # [B, S] bool
    loop_prob: float,
    Fa: float,
    Fb: float,
    max_iters: int = 40,
    epsilon: float = 1e-6,
    converged0=None,
    last_elbo0=None,
    fb_impl: Optional[str] = None,
    plateau_ulps: float = 0.0,
    plateau_iters: int = 2,
    plateau0=None,
) -> ShardedVBxResult:
    """Batched VB-HMM over a ('dp', 'sp') mesh.

    B must divide by |'dp'| and T by |'sp'|. Semantics of
    engine.vbhmm.vbx_batched, including converged0/last_elbo0/plateau0
    mid-EM resume.

    fb_impl: None/'structured' (default) runs the plain-torch blockwise
    smoother at X's dtype (float64 included): on a 1-'sp'-shard mesh it is
    the sequential smoother itself, and across shards it agrees to
    reduction-order rounding. 'pallas' / 'pallas_bf16' run every shard's
    block operator through K2 and both local passes through K1 (float32,
    streams in float32 or bfloat16; tolerance parity like the
    single-device kernel route). Past K2's S_MAX speakers the kernel route
    raises on a card and falls back to 'structured' with a UserWarning on
    the CPU. Results are assembled on the mesh's first device.
    """
    n_dp, n_sp = mesh.shape["dp"], mesh.shape["sp"]
    X = torch.as_tensor(X)
    gamma = torch.as_tensor(gamma)
    B, T, S = gamma.shape
    if B % n_dp or T % n_sp:
        raise ValueError(f"vbx_sharded needs B % n_dp == 0 and T % n_sp "
                         f"== 0, got B={B}, T={T} on mesh {mesh.shape}")
    fb_impl = fb_impl or "structured"
    if fb_impl not in ("structured", *_KERNEL_IMPLS):
        raise ValueError(f"vbx_sharded: unknown fb_impl {fb_impl!r}")
    if fb_impl in _KERNEL_IMPLS and S > K2_S_MAX:
        fb_impl = _over_kernel_capacity(fb_impl, S, mesh.first_device,
                                        cap=K2_S_MAX,
                                        kernel="operator-product kernel")
    kernel = fb_impl in _KERNEL_IMPLS
    dtype = torch.float32 if kernel else X.dtype

    def whole(x, default, dt):
        return default if x is None else torch.as_tensor(x).to(dt)

    inputs = dict(
        X=X.to(dtype), gamma=gamma.to(dtype),
        pi=torch.as_tensor(pi).to(dtype),
        frame_mask=torch.as_tensor(frame_mask).to(torch.bool),
        speaker_mask=torch.as_tensor(speaker_mask).to(torch.bool),
        converged0=whole(converged0, torch.zeros((B,), dtype=torch.bool),
                         torch.bool),
        # the fresh-start sentinel in the ENGINE dtype (engine.vbhmm)
        last_elbo0=whole(last_elbo0, torch.full((B,), NEG_INF, dtype=dtype),
                         dtype),
        plateau0=whole(plateau0, torch.zeros((B,), dtype=torch.int32),
                       torch.int32))
    phi = torch.as_tensor(phi).to(dtype)
    Bl, Tl = B // n_dp, T // n_sp
    cfg = dict(loop_prob=loop_prob, Fa=Fa, Fb=Fb, epsilon=epsilon,
               plateau_ulps=plateau_ulps, plateau_iters=plateau_iters)
    rows = []
    with full_fp32_matmuls():
        for r in range(n_dp):
            lanes = []
            for k, dev in enumerate(mesh.devices[r]):
                b, t = slice(r * Bl, (r + 1) * Bl), slice(k * Tl, (k + 1) * Tl)
                ln = {n: (x[b, t] if n in ("X", "gamma", "frame_mask")
                          else x[b]).to(dev) for n, x in inputs.items()}
                ln["phi"] = phi.to(dev)
                lanes.append(ln)
            rows.append(
                _kernel_row(mesh, lanes, cfg, max_iters, _KERNEL_IMPLS[fb_impl])
                if kernel else _structured_row(mesh, lanes, cfg, max_iters))
        fin = _run_mesh(mesh, rows, max_iters)

    dev0 = mesh.first_device
    gamma_out = torch.cat([torch.cat([sh["gamma"].to(dev0, dtype)
                                      for sh in row], 1) for row in fin])
    pi_out, elbo = (torch.cat([row[0][n].to(dev0) for row in fin])
                    for n in ("pi", "elbo"))
    if kernel:
        n_iters = (~torch.isnan(elbo)).sum(1).to(torch.int32)
    else:
        n_iters = torch.cat([row[0]["n_iters"].to(dev0) for row in fin])
    return ShardedVBxResult(gamma_out, pi_out, elbo, n_iters)
