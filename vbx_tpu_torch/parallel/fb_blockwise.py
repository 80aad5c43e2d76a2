"""Frame-sharded (sequence-parallel) forward-backward for the VB-HMM (port
of vbx_tpu.parallel.fb_blockwise).

The smoother is the one sequential dependency of the VB loop (reference
VBx/VBx.py:164-171). To shard the frame axis of a recording over the K
'sp' shards of a mesh row, each shard summarizes its block of frames as a
transition-operator product, HMM's counterpart of blockwise attention.
With per-frame operators N_t = (tr + eps) @ diag(w_t) (scaled linear
domain, ops.forward_backward), forward messages satisfy a_t = a_{t-1} N_t
and backward messages b_{t-1} = N_t b_t — one chain read both ways. So:

1. each shard computes its block operator F_k = prod_t N_t,
2. the K operators are all-gathered (K * S^2 numbers),
3. every shard computes every block's incoming boundary messages (two
   K-step [S]-vector scans),
4. each shard runs both local vector passes from its boundary messages,
   giving exact per-frame posteriors. log_px is the psum of the local
   passes' per-frame normalizers (m_t + log c_t), never the operator
   scan's sequentially accumulated scale, whose float32 error grows with T
   (vbx_tpu measured ~3.6e2 at T=32768; that noise fired the ELBO stop
   rule early).

One 'sp' shard short-circuits to the sequential smoother itself, so a
1-shard mesh is the single-device engine.

vbx_tpu runs these functions inside shard_map, one program per device, and
under vmap over recordings. Here one process drives the shards: each
function takes the shards of one dp row as lists (shard k's tensors on its
device, batched over B recordings) and returns one result per shard,
exchanging data through Mesh.psum and Mesh.all_gather.

Two forms:
- `forward_backward_blockwise`: plain torch at the input dtype (float64
  included), comparable to the sequential smoother to rounding;
- `forward_backward_blockwise_kernel`: float32 around the hand-written
  CUDA kernels — K2 (ops.fb_product_kernel) for the block operators and K1
  (ops.fb_kernel) for both local passes — in the E-step's [B, Tb, S]
  layout (vbx_tpu's layout='bts').
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from vbx_tpu_torch.ops.fb_kernel import fb_scan_sb_logp_bts
from vbx_tpu_torch.ops.fb_product_kernel import fb_fwd_product_sb
from vbx_tpu_torch.ops.forward_backward import (_normalize_logp,
                                                forward_backward_structured)
from vbx_tpu_torch.parallel.mesh import Mesh

_TINY32 = torch.finfo(torch.float32).tiny
Shards = Sequence[torch.Tensor]


class BlockFBResult(NamedTuple):
    gamma: torch.Tensor     # [B, Tb, S] posteriors for the local block
    log_px: torch.Tensor    # [B] total log-likelihoods (psum'd)
    pi_stat: torch.Tensor   # [B, S] transition-occupation stat (psum'd)
    gamma0: torch.Tensor    # [B, S] posterior of the global first frame


def _boundary_messages(F: torch.Tensor, s: Optional[torch.Tensor],
                       u_hat: torch.Tensor):
    """Incoming forward and backward boundary messages of every block from
    the gathered operators F [K, B, S, S] (true operator
    diag(exp(s[k])) @ F[k] when row scales s [K, B, S] are given):
    v_in[k] = normalize(u_hat F_0 ... F_{k-1}),
    b_in[k] = normalize(F_{k+1} ... F_{K-1} 1). Returns two [K] lists."""
    K, B, S = F.shape[:3]
    v = u_hat
    v_in = []
    for k in range(K):
        v_in.append(v)
        if s is None:
            v2 = torch.matmul(v[:, None, :], F[k])[:, 0]
        else:
            ms = s[k].amax(-1, keepdim=True)
            v2 = torch.matmul((v * torch.exp(s[k] - ms))[:, None, :],
                              F[k])[:, 0]
        v = v2 / v2.sum(-1, keepdim=True)
    b = torch.full((B, S), 1.0 / S, dtype=F.dtype, device=F.device)
    b_in = [None] * K
    for k in range(K - 1, -1, -1):
        b_in[k] = b
        b2 = torch.matmul(F[k], b[:, :, None])[:, :, 0]
        if s is not None:
            b2 = torch.exp(s[k] - s[k].amax(-1, keepdim=True)) * b2
        b = b2 / b2.sum(-1, keepdim=True)
    return v_in, b_in


def forward_backward_blockwise(
    log_p: Shards,
    pi: Shards,
    loop_prob,
    mesh: Mesh,
    eps: float = 1e-8,
    frame_mask: Optional[Shards] = None,
) -> List[BlockFBResult]:
    """Scaled structured-transition smoother over the shards of one dp row.

    log_p[k]:      [B, Tb, S] shard k's frames of B recordings (padded
                   frames, a suffix of the global frame axis, are False in
                   frame_mask[k] [B, Tb]).
    pi[k]:         [B, S] speaker priors (the same on every shard).
    Matches the sequential `forward_backward_structured` to rounding,
    including the reference's +eps transition regularization
    (VBx/VBx.py:98,163).
    """
    K = len(log_p)
    if frame_mask is None:
        frame_mask = [torch.ones(x.shape[:2], dtype=torch.bool,
                                 device=x.device) for x in log_p]
    if K == 1:
        seq = forward_backward_structured(log_p[0], pi[0], loop_prob,
                                          eps=eps, frame_mask=frame_mask[0])
        return [BlockFBResult(seq.gamma, seq.log_px, seq.pi_stat,
                              seq.gamma[:, 0])]

    local = []
    for k in range(K):
        lp_k, valid = log_p[k], frame_mask[k].to(torch.bool)
        dtype, dev = lp_k.dtype, lp_k.device
        B, Tb, S = lp_k.shape
        lp = torch.as_tensor(loop_prob, dtype=dtype, device=dev)
        eps_c = torch.as_tensor(eps, dtype=dtype, device=dev)
        pi_k = pi[k].to(dtype)
        col = (1.0 - lp) * pi_k + eps_c
        w, m = _normalize_logp(lp_k, valid)
        # ---- 1. block operator F_k = prod_t N_t, max-normalized per step;
        # frame 0 of block 0 is pure emission (no transition before the
        # first frame). Its scale is not kept: the boundary scans
        # renormalize per block and log_px comes from the vector passes.
        A = torch.eye(S, dtype=dtype, device=dev).expand(B, S, S)
        for t in range(Tb):
            w_t = w[:, t, None, :]
            if k == 0 and t == 0:
                A_new = A * w_t
            else:
                A_new = (lp * A + A.sum(2, keepdim=True) * col[:, None, :]
                         ) * w_t
            A_new = A_new / A_new.amax((1, 2), keepdim=True)
            A = torch.where(valid[:, t, None, None], A_new, A)
        local.append(dict(lp=lp, col=col, w=w, m=m, valid=valid, F=A,
                          u0=pi_k + eps_c))

    # ---- 2. exchange the block operators ---------------------------------
    F_all = mesh.all_gather([d["F"] for d in local])

    outs = []
    for k, d in enumerate(local):
        lp, col, w, valid, u0 = d["lp"], d["col"], d["w"], d["valid"], d["u0"]
        B, Tb, S = w.shape
        # ---- 3. boundary messages (every shard computes all; K is tiny)
        v_in, b_in = _boundary_messages(
            F_all[k], None, u0 / u0.sum(-1, keepdim=True))
        # ---- 4. local vector passes. Shard 0 starts from the UNNORMALIZED
        # pi + eps, as the sequential smoother does (its first frame is
        # pure emission).
        prev = u0 if k == 0 else v_in[k]
        ahat, cfw = [], []
        for t in range(Tb):
            w_t, valid_t = w[:, t], valid[:, t, None]
            a = w_t * prev if k == 0 and t == 0 else w_t * (lp * prev + col)
            c = a.sum(-1, keepdim=True)
            prev = torch.where(valid_t, a / c, prev)
            ahat.append(prev)
            cfw.append(torch.where(valid_t, c, torch.ones_like(c))[:, 0])
        ahat, cfw = torch.stack(ahat, 1), torch.stack(cfw, 1)   # [B,Tb,(S)]
        nxt = b_in[k]
        bhat = [nxt]
        for j in range(Tb - 2, -1, -1):
            u = w[:, j + 1] * nxt
            b = lp * u + (col * u).sum(-1, keepdim=True)
            nxt = torch.where(valid[:, j + 1, None],
                              b / b.sum(-1, keepdim=True), nxt)
            bhat.append(nxt)
        bhat = torch.stack(bhat[::-1], 1)
        # ---- 5. outputs (within-frame normalized; scales cancel)
        zero = torch.zeros((), dtype=w.dtype, device=w.device)
        tiny = torch.finfo(w.dtype).tiny
        ab = ahat * bhat
        denom = torch.clamp(ab.sum(-1, keepdim=True), min=tiny)
        gamma = (ab / denom) * valid[:, :, None].to(w.dtype)
        not_first = valid.clone()
        if k == 0:
            not_first[:, 0] = False
        r_over_c = 1.0 / (denom[..., 0] * cfw)
        terms = w * bhat * r_over_c[..., None]
        outs.append(dict(
            gamma=gamma,
            log_px=torch.where(valid, d["m"] + torch.log(cfw), zero).sum(1),
            pi_stat=(terms * not_first[..., None].to(w.dtype)).sum(1),
            gamma0=gamma[:, 0] if k == 0 else torch.zeros_like(gamma[:, 0])))
    return _psum_outputs(mesh, outs)


def _psum_outputs(mesh: Mesh, outs) -> List[BlockFBResult]:
    log_px, pi_stat, gamma0 = (mesh.psum([o[n] for o in outs])
                               for n in ("log_px", "pi_stat", "gamma0"))
    return [BlockFBResult(o["gamma"], *x)
            for o, x in zip(outs, zip(log_px, pi_stat, gamma0))]


def _auto_segments(Tb: int, S: int, B: int, lane_cap: int = 512,
                   min_seg: int = 128) -> int:
    """Largest power-of-two segment count R for the operator-product walk
    (vbx_tpu's rule, so both packages split blocks alike): R * B * S walks
    (<= lane_cap), segments of >= min_seg frames, and R | Tb so segments
    tile the block exactly."""
    R = 1
    while (Tb % (R * 2) == 0 and (R * 2) * B * S <= lane_cap
           and Tb // (R * 2) >= min_seg):
        R *= 2
    return R


class BlockFBBatchResult(NamedTuple):
    gamma: torch.Tensor     # [Tb, S, B] posteriors for the local block
    log_px: torch.Tensor    # [B] total log-likelihoods (psum'd)
    pi_stat: torch.Tensor   # [S, B] transition-occupation stat (psum'd)
    gamma0: torch.Tensor    # [S, B] posterior of the global first frame


def forward_backward_blockwise_kernel(
    log_p: Shards,
    pi: Shards,
    loop_prob,
    mesh: Mesh,
    eps: float = 1e-8,
    frame_mask: Optional[Shards] = None,
    speaker_mask: Optional[Shards] = None,
    recip: bool = True,
    io_dtype: torch.dtype = torch.float32,
    n_segments: Optional[int] = None,
) -> List[BlockFBBatchResult]:
    """Frame-sharded smoother on the hand-written kernels: the counterpart
    of vbx_tpu's `forward_backward_blockwise_pallas` with layout='bts'.

    log_p[k]:        [B, Tb, S] float32, shard k's frames (the E-step
                     product's native layout; absent speakers NEG_INF).
    pi[k]:           [B, S] speaker priors (the same on every shard).
    frame_mask[k]:   [Tb, B] frame validity (padding a suffix).
    speaker_mask[k]: [B, S] speaker validity.
    Outputs keep vbx_tpu's [Tb, S, B] / [S, B] layout (gamma is a view of
    a [B, Tb, S] buffer). Three steps per call, as in vbx_tpu:

    1. each shard's block operator: K2 walks R segments of Ts = Tb / R
       frames (n_segments=None: `_auto_segments`), every row i of a
       segment from e_i (the global first frame) or from the incoming
       transition lp * e_i + col. A segment that is entirely padding
       becomes the identity (K2 would leave the folded-in transition
       there). The R row-scaled operators compose into F_k with a
       [B, S, S] product scan;
    2. all-gather of the operators and their row scales, and the two
       K-step boundary scans with per-row scales;
    3. both local vector passes in one K1 walk from the boundary messages,
       padded frames skipped exactly (zero_invalid).

    One 'sp' shard skips steps 1-2 and runs K1 as the single-device engine
    does (pinit = pi + eps, uniform backward start). Accuracy is the
    kernel route's contract (~5e-5 on gamma); carries stay float32 and the
    streams may be bfloat16 (io_dtype).
    """
    K = len(log_p)
    f32 = torch.float32
    local = []
    for k in range(K):
        lp_k = log_p[k].to(f32)
        dev = lp_k.device
        B, Tb, S = lp_k.shape
        lp = torch.as_tensor(loop_prob, dtype=f32, device=dev)
        eps_c = torch.as_tensor(eps, dtype=f32, device=dev)
        pi_k = pi[k].to(f32)
        col = (1.0 - lp) * pi_k + eps_c                          # [B, S]
        valid = (torch.ones((Tb, B), dtype=torch.bool, device=dev)
                 if frame_mask is None else frame_mask[k].to(torch.bool))
        vmask = valid.to(f32)                                    # [Tb, B]
        smask = (torch.ones((B, S), dtype=f32, device=dev)
                 if speaker_mask is None else speaker_mask[k].to(f32))
        d = dict(log_p=lp_k, lp=lp, col=col, valid=valid, vmask=vmask,
                 smask=smask, u0=pi_k + eps_c)
        if K > 1:
            d.update(_block_operator(lp_k, col, loop_prob, vmask, smask,
                                     k == 0, n_segments, io_dtype))
        local.append(d)

    if K > 1:
        F_all = mesh.all_gather([d["F"] for d in local])
        s_all = mesh.all_gather([d["s"] for d in local])

    outs = []
    for k, d in enumerate(local):
        u0, col, lp, vmask = d["u0"], d["col"], d["lp"], d["vmask"]
        B, S = u0.shape
        if K == 1:
            finit = u0
            b_in = torch.full((B, S), 1.0 / S, dtype=f32, device=u0.device)
        else:
            v_in, b_all = _boundary_messages(
                F_all[k], s_all[k], u0 / u0.sum(-1, keepdim=True))
            b_in = b_all[k]
            # shard 0 starts from the UNNORMALIZED pi + eps, like the
            # single-device engine
            finit = u0 if k == 0 else lp * v_in[k] + col
        ahat, bhat, cfw, m, w = fb_scan_sb_logp_bts(
            d["log_p"], d["smask"], d["valid"], col.T, finit.T, loop_prob,
            recip=recip, io_dtype=io_dtype, binit=b_in.T, zero_invalid=True)
        # log_px from the local per-frame normalizers (m_t + log c_t)
        a, b = ahat.to(f32), bhat.to(f32)                     # [Tb, S, B]
        ab = a * b
        denom = torch.clamp(ab.sum(1, keepdim=True), min=_TINY32)
        gamma = (ab / denom) * vmask[:, None, :]
        not_first = vmask.clone()
        if k == 0:
            not_first[0] = 0.0
        terms = w.to(f32) * b / (denom * cfw[:, None, :])
        outs.append(dict(
            gamma=gamma,
            log_px=(vmask * (m + torch.log(cfw))).sum(0),
            pi_stat=(terms * not_first[:, None, :]).sum(0),
            gamma0=gamma[0] if k == 0 else torch.zeros_like(gamma[0])))
    return [BlockFBBatchResult(*r) for r in _psum_outputs(mesh, outs)]


def _block_operator(log_p, col, loop_prob, vmask, smask, first_shard: bool,
                    n_segments: Optional[int], io_dtype) -> dict:
    """One shard's block operator in the row-scaled form
    F = diag(exp(s)) @ F_hat: K2 over R segments, dead segments set to the
    identity, then the [B, S, S] compose scan. Returns {'F': [B, S, S],
    's': [B, S]}."""
    f32 = torch.float32
    B, Tb, S = log_p.shape
    dev = log_p.device
    R = n_segments if n_segments is not None else _auto_segments(Tb, S, B)
    if Tb % R:
        raise ValueError(f"n_segments={R} must divide the local frame "
                         f"extent Tb={Tb}")
    m_bt = log_p.amax(2)                                         # [B, Tb]
    vm_bt = vmask.T                                              # [B, Tb]
    w = (torch.exp(log_p - m_bt[:, :, None]) * smask[:, None, :]
         * vm_bt[:, :, None]).to(io_dtype).contiguous()          # [B,Tb,S]
    eye = torch.eye(S, dtype=f32, device=dev)
    fold = (float(loop_prob) * eye + col[:, None, :]).expand(R, B, S, S)
    # every segment's first frame folds in the incoming transition, except
    # the global first frame (segment 0 of shard 0), which is pure emission
    finit = fold.clone()
    if first_shard:
        finit[0] = eye
    fhat, ls = fb_fwd_product_sb(w, col.contiguous(), finit.contiguous(),
                                 loop_prob)
    msum = (vm_bt * m_bt).reshape(B, R, Tb // R).sum(2).T        # [R, B]
    s_seg = ls + msum[:, :, None]                                # [R, B, S]
    dead = vm_bt.reshape(B, R, Tb // R).sum(2).T == 0.0          # [R, B]
    fhat = torch.where(dead[:, :, None, None], eye, fhat)
    s_seg = torch.where(dead[:, :, None], 0.0, s_seg)
    # F = F_seg0 @ ... @ F_seg{R-1} in the row-scaled form
    C, cs = fhat[0], s_seg[0]
    for r in range(1, R):
        sr = s_seg[r]
        mx = sr.amax(-1, keepdim=True)                           # [B, 1]
        inner = torch.matmul(C * torch.exp(sr - mx)[:, None, :], fhat[r])
        rn = torch.clamp(inner.amax(-1), min=_TINY32)            # [B, S]
        C = inner / rn[:, :, None]
        cs = cs + mx + torch.log(rn)
    return {"F": C, "s": cs}
