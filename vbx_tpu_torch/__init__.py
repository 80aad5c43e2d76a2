"""vbx_tpu_torch — the PyTorch/CUDA port of vbx_tpu.

VB-HMM speaker diarization from precomputed x-vectors (ark + segments +
PLDA + x-vector transform -> RTTM) on an NVIDIA GPU. The module layout and
function names follow vbx_tpu, which stays the reference this package is
tested against; nothing here imports jax or vbx_tpu. The one hand-written
CUDA kernel (ops.fb_kernel, csrc/fb_fused_sb.cu) replaces vbx_tpu's fused
Pallas forward-backward kernel.

Entry points take a `device` argument: 'cuda' unless the caller passes
'cpu' (device.resolve_device); with no card they raise instead of falling
back to the CPU.
"""

__version__ = "0.1.0"

from vbx_tpu_torch.config import (  # noqa: F401
    DATASET_PRESETS, DiarizationConfig, config_from_dict, config_to_dict,
    get_preset,
)
