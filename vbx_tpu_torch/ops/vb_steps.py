"""VB-HMM E/M-step ops (port of vbx_tpu.ops.vb_steps).

Model: zero-mean PLDA-space Gaussians with diagonal across-class covariance
Phi and identity within-class covariance; speaker posteriors q(y_s) are
Gaussians with mean alpha[s] and diagonal precision-inverse invL[s]
(reference math: VBx/VBx.py:87-100, eqs. (16)-(25) of Landini et al. 2022).

Shapes: [..., T, D] features, [..., T, S] responsibilities, [..., S, D]
speaker models; leading batch dimensions broadcast, so the single-recording
and batched engines share these functions. The two products ([S,T]x[T,D]
stats and [T,D]x[D,S] log-likelihoods) are plain torch.matmul calls: vbx_tpu
left them to XLA outside any Pallas kernel. Callers run them under
device.full_fp32_matmuls, the counterpart of the JAX package's
Precision.HIGHEST. Padded speakers/frames are handled by zeroed gamma
rows/columns (their invL becomes 1 and alpha 0, so they contribute exactly
0 to the ELBO model term, matching an unpadded run).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def vb_precompute(X: torch.Tensor, phi: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-recording constants: G[t] = -0.5*(sum_d X[t]^2 + D*log(2*pi)) and
    rho = X * sqrt(phi) (reference: VBx.py:87-89). G keeps a trailing
    singleton axis ([..., T, 1])."""
    D = X.shape[-1]
    log2pi = torch.tensor(math.log(2 * math.pi), dtype=X.dtype,
                          device=X.device)
    G = -0.5 * ((X * X).sum(-1, keepdim=True) + D * log2pi)
    rho = X * torch.sqrt(phi).to(X.dtype)
    return G, rho


def vb_m_step(gamma: torch.Tensor, rho: torch.Tensor, phi: torch.Tensor,
              fa_over_fb) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speaker-model update: invL[s,d] = 1/(1 + Fa/Fb * N_s * phi_d),
    alpha = Fa/Fb * invL * (gamma^T rho) (reference: VBx.py:95-96).

    gamma: [..., T, S] responsibilities (padded frames must be zero rows).
    rho:   [..., T, D].
    Returns (invL, alpha), both [..., S, D].
    """
    dtype = rho.dtype
    fa_over_fb = torch.as_tensor(fa_over_fb, dtype=dtype, device=rho.device)
    counts = gamma.sum(-2)                                     # [..., S]
    invL = 1.0 / (1.0 + fa_over_fb * counts[..., :, None]
                  * phi.to(dtype))
    stats = torch.matmul(gamma.transpose(-1, -2), rho)        # [..., S, D]
    alpha = fa_over_fb * invL * stats
    return invL, alpha


def vb_log_likelihoods(rho: torch.Tensor, G: torch.Tensor,
                       invL: torch.Tensor, alpha: torch.Tensor,
                       phi: torch.Tensor, fa) -> torch.Tensor:
    """Per-frame per-speaker expected log-likelihoods
    log_p[t,s] = Fa*(rho[t]@alpha[s] - 0.5*(invL[s]+alpha[s]^2)@phi + G[t])
    (reference: VBx.py:97). G is [..., T, 1]. Returns [..., T, S]."""
    dtype = rho.dtype
    fa = torch.as_tensor(fa, dtype=dtype, device=rho.device)
    cross = torch.matmul(rho, alpha.transpose(-1, -2))        # [..., T, S]
    quad = torch.matmul(invL + alpha * alpha, phi.to(dtype))  # [..., S]
    return fa * (cross - 0.5 * quad[..., None, :] + G)


def vb_elbo_model_term(invL: torch.Tensor, alpha: torch.Tensor,
                       fb) -> torch.Tensor:
    """Speaker-model KL part of the ELBO:
    Fb * 0.5 * sum(log(invL) - invL - alpha^2 + 1) over the last two axes
    (reference: VBx.py:100). Padded speakers (invL==1, alpha==0) contribute
    exactly 0."""
    fb = torch.as_tensor(fb, dtype=invL.dtype, device=invL.device)
    return fb * 0.5 * (torch.log(invL) - invL - alpha * alpha
                       + 1.0).sum((-2, -1))


def vb_pi_update(gamma0: torch.Tensor, pi: torch.Tensor,
                 pi_stat: torch.Tensor, loop_prob) -> torch.Tensor:
    """Speaker-prior update pi <- gamma[0] + (1-loopP)*pi*pi_stat, normalized
    over the last axis (reference: VBx.py:101-104). Padded speakers keep
    pi == 0 since both terms vanish there."""
    loop_prob = torch.as_tensor(loop_prob, dtype=pi.dtype, device=pi.device)
    new_pi = gamma0 + (1.0 - loop_prob) * pi * pi_stat
    return new_pi / new_pi.sum(-1, keepdim=True)
