"""vbx_tpu_torch — the PyTorch/CUDA port of vbx_tpu.

Speaker diarization on an NVIDIA GPU: x-vector extraction from audio
(wav + VAD -> fbank/CMVN -> ResNet -> ark + segments, engine.extractor)
and VB-HMM diarization of the x-vectors (ark + segments + PLDA + x-vector
transform -> RTTM). The module layout and function names follow
vbx_tpu, which stays the reference this package is tested against;
nothing here imports jax or vbx_tpu. Hand-written CUDA kernels (csrc/,
behind ops.fb_kernel, ops.fb_product_kernel and ops.fb_scan_kernel)
replace vbx_tpu's Pallas forward-backward kernels.

Entry points take a `device` argument: 'cuda' unless the caller passes
'cpu' (device.resolve_device); with no card they raise instead of falling
back to the CPU.
"""

__version__ = "0.1.0"

from vbx_tpu_torch.config import (  # noqa: F401
    DATASET_PRESETS, DiarizationConfig, config_from_dict, config_to_dict,
    get_preset,
)
