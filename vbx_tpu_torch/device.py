"""Device pick, full-f32 matmul guard, and the rule against CPU fallback.

Every entry point of the port takes a `device` argument and resolves it
here. The default is the CUDA card; the CPU runs only when a caller names
it (the tests do). With no card and no explicit 'cpu' the call raises: a
diarization run that quietly moved to the CPU would be orders of magnitude
slower and would never launch the CUDA kernel, so it must not look like a
GPU run.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """'cuda' unless the caller asks for another device; raises when the
    requested device is a CUDA card and none is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU explicitly")
    return dev


@contextlib.contextmanager
def full_fp32_matmuls():
    """Run float32 matrix products and convolutions at full float32.

    The counterpart of vbx_tpu's Precision.HIGHEST (vbx_tpu/ops/vb_steps.py
    module docstring): TF32 keeps ~10 mantissa bits, and at corpus scale
    (T~1e4, |ELBO|~1e6) that rounding puts enough noise on the ELBO to fire
    the delta<epsilon stop rule early. PyTorch leaves float32 matmuls at
    full precision by default but lets cuDNN convolutions use TF32, and any
    caller can turn either on; the fidelity path pins both off for its
    duration and restores the caller's settings afterwards. bfloat16
    operands are unaffected (the bf16 route upcasts to float32 first).
    """
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def torch_dtype(name) -> torch.dtype:
    """'float32' / 'float64' / a torch dtype -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))
