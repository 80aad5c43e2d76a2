"""Embedding models and the DSP frontend (torch): the ResNet x-vector
family, its checkpoint import, and the fbank/CMVN features."""

from vbx_tpu_torch.models.resnet import (  # noqa: F401
    BasicBlock, Bottleneck, ResNetXVector, SELayer, convert_torch_state_dict,
    fold_batchnorm, load_torch_checkpoint, resnet34, resnet101, se_resnet34,
    state_dict_from_flax,
)
