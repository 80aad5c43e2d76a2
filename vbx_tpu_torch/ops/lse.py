"""Masking constant and stable log-sum-exp shared by the VB ops (port of
vbx_tpu.ops.lse).

Masked lanes hold a large-but-finite negative constant instead of -inf:
exp(NEG_INF) == 0 in f32 and f64, while NEG_INF - NEG_INF == 0 stays finite
(a true -inf would give NaN via inf - inf when a whole lane is masked).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def masked_fill(x: torch.Tensor, mask: torch.Tensor,
                fill: float = NEG_INF) -> torch.Tensor:
    """Replace entries where mask is False with `fill`."""
    return torch.where(mask, x, torch.full((), fill, dtype=x.dtype,
                                           device=x.device))


def logsumexp(x: torch.Tensor, dim: int = -1,
              keepdim: bool = False) -> torch.Tensor:
    """Stable logsumexp that returns NEG_INF (not nan) for all-NEG_INF
    lanes."""
    m_safe = torch.clamp(x.amax(dim, keepdim=True), min=NEG_INF)
    out = m_safe + torch.log(torch.exp(x - m_safe).sum(dim, keepdim=True))
    return out if keepdim else out.squeeze(dim)


def masked_logsumexp(x: torch.Tensor, mask: torch.Tensor, dim: int = -1,
                     keepdim: bool = False) -> torch.Tensor:
    """logsumexp over entries where mask is True."""
    return logsumexp(masked_fill(x, mask), dim=dim, keepdim=keepdim)
