"""ONNX checkpoint import for the ResNet x-vector family.

The reference example recipe runs its extractor from `final.onnx` through
onnxruntime (`VBx/predict.py:126-129`, `run_example.sh:13-20`); that file is
an export of the released torch ResNet101. Here an ONNX file is a *weight
source*, as in vbx_tpu.models.onnx_import: the graph is parsed first-party
(`vbx_tpu_torch/io/onnx.py`), the conv / batch-norm / embedding tensors are
recovered by walking it, and they become the port's ResNet state dict
(`vbx_tpu_torch/models/resnet.py`) — no onnxruntime anywhere.

Torch's ONNX exporter constant-folds BatchNorm into the preceding conv
(conv gains a bias; BN node disappears) and anonymizes initializer names
(`onnx::Conv_174`), so the import cannot key off parameter names the way
the torch-checkpoint path does. Instead the conv sequence is segmented
against the ResNet family's block grammar (stem, then per-layer
Bottleneck 1x1-3x3-1x1 / BasicBlock 3x3-3x3 groups with optional 1x1
projection shortcuts, in trace order — shortcut traced after the branch
convs), with every shape and stride verified against the grammar.
Exports that keep BatchNormalization nodes are handled too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vbx_tpu_torch.io.onnx import OnnxGraph, read_onnx

_BN_EPS = 1e-5


@dataclass
class _ConvSpec:
    weight: np.ndarray            # OIHW
    bias: Optional[np.ndarray]
    strides: Tuple[int, int]
    bn: Optional[Dict[str, np.ndarray]]   # scale/bias/mean/var if unfolded


def _resolve_identity(graph: OnnxGraph) -> Dict[str, str]:
    """Map tensor name -> canonical producer output through Identity chains."""
    alias: Dict[str, str] = {}
    for n in graph.nodes:
        if n.op_type == "Identity" and n.inputs and n.outputs:
            src = n.inputs[0]
            alias[n.outputs[0]] = alias.get(src, src)
    return alias


def _collect(graph: OnnxGraph
             ) -> Tuple[List[_ConvSpec], np.ndarray, np.ndarray]:
    """Extract ordered conv specs (with any trailing BN attached) and the
    embedding Gemm weights from the graph."""
    alias = _resolve_identity(graph)
    init = dict(graph.initializers)
    for dst, src in alias.items():
        if src in init:
            init[dst] = init[src]

    convs: List[_ConvSpec] = []
    conv_by_output: Dict[str, _ConvSpec] = {}
    gemm_w = gemm_b = None
    def tensor(name: str, what: str) -> np.ndarray:
        key = alias.get(name, name)
        if key not in init:
            raise ValueError(
                f"{what} {name!r} is not a graph initializer (produced by "
                f"a node?); only plain-weight graphs are supported")
        return init[key]

    for n in graph.nodes:
        if n.op_type == "Conv":
            w = tensor(n.inputs[1], "Conv weight")
            b = None
            if len(n.inputs) > 2 and n.inputs[2]:
                b = tensor(n.inputs[2], "Conv bias")
            strides = tuple(n.attrs.get("strides", [1, 1]))
            if n.attrs.get("group", 1) != 1:
                raise ValueError("grouped convolutions not in this family")
            # the model hardcodes torch-ResNet padding (k//2 per side)
            # and unit dilation; a graph deviating from that would load
            # with matching shapes but compute different activations, so
            # reject it here rather than import silently wrong
            kh, kw = np.asarray(w).shape[2:]
            auto_pad = n.attrs.get("auto_pad", b"NOTSET")
            if auto_pad not in (b"NOTSET", "NOTSET"):
                raise ValueError(f"unsupported Conv auto_pad {auto_pad!r}")
            # ONNX spec default for a missing `pads` is all-zero, NOT the
            # torch k//2 convention the model hardcodes
            pads = tuple(n.attrs.get("pads", [0, 0, 0, 0]))
            if pads != (kh // 2, kw // 2, kh // 2, kw // 2):
                raise ValueError(
                    f"Conv pads {pads} != torch-ResNet convention "
                    f"{(kh // 2, kw // 2, kh // 2, kw // 2)}")
            if tuple(n.attrs.get("dilations", [1, 1])) != (1, 1):
                raise ValueError("dilated convolutions not in this family")
            spec = _ConvSpec(weight=np.asarray(w), bias=b,
                             strides=strides, bn=None)
            convs.append(spec)
            conv_by_output[n.outputs[0]] = spec
        elif n.op_type == "BatchNormalization":
            x = alias.get(n.inputs[0], n.inputs[0])
            spec = conv_by_output.get(x)
            if spec is None:
                raise ValueError(
                    "BatchNormalization not fed by a Conv; unsupported graph")
            eps = n.attrs.get("epsilon", _BN_EPS)
            if abs(eps - _BN_EPS) > 1e-8:
                raise ValueError(f"unsupported BatchNorm epsilon {eps}")
            names = ("scale", "bias", "mean", "var")
            spec.bn = {k: np.asarray(tensor(v, f"BatchNorm {k}"))
                       for k, v in zip(names, n.inputs[1:5])}
            conv_by_output[n.outputs[0]] = spec
        elif n.op_type == "Gemm":
            if n.attrs.get("transB", 0) != 1 or \
                    n.attrs.get("alpha", 1.0) != 1.0 or \
                    n.attrs.get("beta", 1.0) != 1.0:
                raise ValueError("unsupported Gemm attributes")
            if gemm_w is not None:
                raise ValueError(
                    "multiple Gemm nodes; the x-vector family has exactly "
                    "one embedding layer")
            gemm_w = np.asarray(tensor(n.inputs[1], "Gemm weight"))
            if len(n.inputs) > 2 and n.inputs[2]:
                gemm_b = np.asarray(tensor(n.inputs[2], "Gemm bias"))
            else:
                # C is optional in the Gemm spec (bias-free nn.Linear)
                gemm_b = np.zeros(gemm_w.shape[0], gemm_w.dtype)
    if gemm_w is None:
        raise ValueError("no Gemm (embedding) node found")
    return convs, gemm_w, gemm_b


def _conv_bn_state(dst: str, bn_dst: str, spec: _ConvSpec
                   ) -> Dict[str, torch.Tensor]:
    """State-dict entries of one conv+BN unit.

    Folded exports carry the BN effect inside (weight, bias); the port's
    BN then applies exactly `+bias`: weight 1, mean 0, var 1-eps (so
    sqrt(var+eps) = 1, the identity of resnet.fold_batchnorm). An
    unfolded BN normalizes (conv + conv_bias) while the port's conv has no
    bias, so the conv bias goes into the running mean:
    BN(z + b) == BN'(z) with mean' = mean - b."""
    out_ch = spec.weight.shape[0]
    if spec.bn is not None:
        mean = np.asarray(spec.bn["mean"])
        if spec.bias is not None:
            mean = mean - np.asarray(spec.bias)
        bn = (spec.bn["scale"], spec.bn["bias"], mean, spec.bn["var"])
    else:
        bias = spec.bias if spec.bias is not None else \
            np.zeros(out_ch, np.float32)
        bn = (np.ones(out_ch, np.float32), bias,
              np.zeros(out_ch, np.float32),
              np.full(out_ch, 1.0 - _BN_EPS, np.float32))

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    out = {f"{dst}.weight": t(spec.weight)}
    for k, v in zip(("weight", "bias", "running_mean", "running_var"), bn):
        out[f"{bn_dst}.{k}"] = t(v)
    out[f"{bn_dst}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return out


def _expect(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"ONNX graph does not match the ResNet "
                         f"x-vector family: {msg}")


def convert_onnx_graph(graph: OnnxGraph
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Segment the conv sequence into ResNet blocks and build the port's
    state dict.

    Returns (state_dict, arch) where arch carries the inferred
    {bottleneck, num_blocks, m_channels, embed_dim, gemm_in, c_last}.
    """
    convs, gemm_w, gemm_b = _collect(graph)
    _expect(len(convs) >= 3, f"only {len(convs)} convs")

    stem = convs[0]
    _expect(stem.weight.shape[1] == 1 and stem.weight.shape[2:] == (3, 3),
            f"stem conv shape {stem.weight.shape}")
    m = stem.weight.shape[0]
    bottleneck = convs[1].weight.shape[2:] == (1, 1)
    expansion = 4 if bottleneck else 1

    sd = _conv_bn_state("conv1", "bn1", stem)
    p = 1                      # next unconsumed conv
    cur_in = m
    num_blocks: List[int] = []

    def take(exp_shape, exp_stride, what) -> _ConvSpec:
        nonlocal p
        _expect(p < len(convs), f"ran out of convs at {what}")
        spec = convs[p]
        _expect(spec.weight.shape == exp_shape,
                f"{what}: shape {spec.weight.shape} != {exp_shape}")
        _expect(spec.strides == (exp_stride, exp_stride),
                f"{what}: strides {spec.strides} != {exp_stride}")
        p += 1
        return spec

    for li, layer_stride in enumerate((1, 2, 2, 2), start=1):
        planes = m * (2 ** (li - 1))
        out_ch = planes * expansion
        bi = 0
        while p < len(convs) and convs[p].weight.shape[0] == planes and \
                convs[p].weight.shape[1] == cur_in:
            blk_stride = layer_stride if bi == 0 else 1
            dst = f"layer{li}.{bi}"
            if bottleneck:
                seq = [("conv1", (planes, cur_in, 1, 1), 1),
                       ("conv2", (planes, planes, 3, 3), blk_stride),
                       ("conv3", (out_ch, planes, 1, 1), 1)]
            else:
                seq = [("conv1", (planes, cur_in, 3, 3), blk_stride),
                       ("conv2", (planes, planes, 3, 3), 1)]
            for cname, shape, stride in seq:
                spec = take(shape, stride, f"{dst}.{cname}")
                sd.update(_conv_bn_state(
                    f"{dst}.{cname}",
                    f"{dst}.{cname.replace('conv', 'bn')}", spec))
            if blk_stride != 1 or cur_in != out_ch:
                spec = take((out_ch, cur_in, 1, 1), blk_stride,
                            f"{dst}.shortcut")
                sd.update(_conv_bn_state(f"{dst}.shortcut.0",
                                         f"{dst}.shortcut.1", spec))
            cur_in = out_ch
            bi += 1
        _expect(bi > 0, f"layer{li} has zero blocks (next conv "
                f"{convs[p].weight.shape if p < len(convs) else 'none'}, "
                f"expected first-conv ({planes}, {cur_in}, ...))")
        num_blocks.append(bi)
    _expect(p == len(convs), f"{len(convs) - p} trailing convs unconsumed")

    sd["embedding.weight"] = torch.from_numpy(
        np.array(gemm_w, dtype=np.float32))
    sd["embedding.bias"] = torch.from_numpy(np.array(gemm_b,
                                                     dtype=np.float32))
    arch = {"bottleneck": bottleneck, "num_blocks": tuple(num_blocks),
            "m_channels": m, "embed_dim": gemm_w.shape[0],
            "gemm_in": gemm_w.shape[1], "c_last": cur_in}
    return sd, arch


def load_onnx_checkpoint(path: str, feat_dim: int = 64,
                         dtype: Optional[torch.dtype] = None):
    """Load an exported ResNet x-vector .onnx into the port's model (on
    the CPU). The sibling of `resnet.load_torch_checkpoint` for the
    reference's ONNX backend (`predict.py:126-129`); `feat_dim` is checked
    against the embedding layer's input width."""
    from vbx_tpu_torch.models.resnet import (BasicBlock, Bottleneck,
                                             ResNetXVector, pooled_freq)

    sd, arch = convert_onnx_graph(read_onnx(path).graph)
    expect_in = 2 * arch["c_last"] * pooled_freq(feat_dim)
    _expect(arch["gemm_in"] == expect_in,
            f"embedding expects {arch['gemm_in']} inputs but feat_dim="
            f"{feat_dim} gives {expect_in}; wrong --ndim for this model?")
    model = ResNetXVector(
        block=Bottleneck if arch["bottleneck"] else BasicBlock,
        num_blocks=arch["num_blocks"], m_channels=arch["m_channels"],
        feat_dim=feat_dim, embed_dim=arch["embed_dim"],
        dtype=dtype if dtype is not None else torch.float32)
    model.load_state_dict(sd)
    return model
