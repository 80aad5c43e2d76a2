"""Masking constant shared by the VB ops (port of vbx_tpu.ops.lse).

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
