"""x-vector embedding model: ResNet with statistics pooling, as torch
modules in NCHW.

The reference PyTorch model's architecture and module names
(VBx/models/resnet.py): ResNet101 = Bottleneck [3, 4, 23, 3], 32 base
channels, 3x3 stem conv (stride 1), stages at strides [1, 2, 2, 2],
statistics pooling over time (mean || std with a +1e-10 variance floor,
resnet.py:138-142) and a linear embedding head (256-d for the shipped
models). A reference `.pth` state dict loads with no renaming:
`conv1`, `bn1`, `layer{l}.{b}.conv{1,2,3}` / `bn{1,2,3}`, `shortcut.0` /
`.1`, `se.fc.0` / `.2`, `embedding`.

Two things follow vbx_tpu.models.resnet rather than the reference:
- `forward(x, lengths)` runs zero-padded windows as if each had its true
  length: activations past a window's valid time prefix are zeroed after
  the stem and after every block (and inside each block where its 3x3 conv
  would read them), lengths halve, rounding up, at every stride-2 stage,
  and the statistics pool over valid frames only. A padded tail window
  (10-143 frames) then gives its unpadded embedding, so all windows of a
  file share one [B, 64, 144] batch.
- `dtype=torch.bfloat16` runs every convolution (and the SE gate) in
  bfloat16; BatchNorm computes in float32, and the residual sums, the
  statistics pool and the embedding stay float32, as in vbx_tpu's
  bfloat16 model. A BatchNorm whose output only a conv reads writes it in
  bfloat16 (the rounding that conv's input cast makes anyway).
- `precision` is vbx_tpu's argument of the same name: 'highest' runs the
  forward inside `device.full_fp32_matmuls` (TF32 off for cuDNN
  convolutions and for matmuls: the counterpart of Precision.HIGHEST);
  None leaves PyTorch's settings as the caller has them (by default cuDNN
  convolutions may use TF32: the counterpart of XLA's DEFAULT). The TF32
  flags are process-global, so 'highest' holds for every thread while a
  forward runs, not for the calling thread alone.
  `engine.extractor.XVectorExtractor` runs its whole extraction inside
  `full_fp32_matmuls`, so there both values run at full float32.

`convert_torch_state_dict` checks a reference state dict against the
architecture (vbx_tpu's depth-strictness and error texts);
`state_dict_from_flax` carries vbx_tpu's Flax variables over.
"""

from __future__ import annotations

import contextlib
import re
import warnings
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vbx_tpu_torch.device import full_fp32_matmuls

_BN_EPS = 1e-5
PRECISIONS = (None, "highest")


def _check_precision(precision: Optional[str]) -> Optional[str]:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    return precision


def _at(precision: Optional[str]):
    """The context a module's forward runs in: full float32 products for
    'highest', the caller's settings for None."""
    return full_fp32_matmuls() if precision == "highest" else \
        contextlib.nullcontext()


def _mask_time(y: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero NCHW activations past the valid time prefix (mask [B, T] bool,
    or None for no mask)."""
    if mask is None:
        return y
    return y * mask[:, None, None, :].to(y.dtype)


def _time_mask(lengths: Optional[torch.Tensor], t: int
               ) -> Optional[torch.Tensor]:
    if lengths is None:
        return None
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """conv in its weight's dtype (bfloat16 on the bfloat16 route)."""
    if x.dtype != conv.weight.dtype:
        x = x.to(conv.weight.dtype)
    return conv(x)


def _bn(bn: nn.BatchNorm2d, y: torch.Tensor) -> torch.Tensor:
    """BatchNorm in float32 whatever the conv's dtype, float32 out."""
    if y.dtype != torch.float32:
        y = y.float()
    return bn(y)


def _bn_relu_to_conv(bn: nn.BatchNorm2d, y: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu(BatchNorm(y)), masked, for an output that only a conv reads.
    BatchNorm computes in float32 (its statistics are float32) and writes
    y's dtype: on the bfloat16 route that is the rounding the next conv's
    cast would make (relu and the 0/1 mask commute with it), without two
    float32 passes over the activations."""
    return _mask_time(F.relu(bn(y)), mask)


def _conv_bn(in_ch: int, out_ch: int, kernel: int, stride: int = 1):
    return (nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                      padding=kernel // 2, bias=False),
            nn.BatchNorm2d(out_ch, eps=_BN_EPS))


class SELayer(nn.Module):
    """Squeeze-and-excitation channel gate (reference: resnet.py:74-89):
    global average pool -> bottleneck MLP (no biases) -> sigmoid channel
    scale. `mask` [B, T] restricts the squeeze to valid frames."""

    def __init__(self, channels: int, reduction: int = 16,
                 precision: Optional[str] = None):
        super().__init__()
        self.precision = _check_precision(precision)
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // reduction, bias=False),
            nn.ReLU(),
            nn.Linear(channels // reduction, channels, bias=False),
            nn.Sigmoid())

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        xf = x.float()
        if mask is None:
            y = xf.mean(dim=(2, 3))                         # [B, C]
        else:
            m = mask[:, None, None, :].float()
            y = (xf * m).sum(dim=(2, 3)) / (m.sum(dim=(2, 3)) * x.shape[2])
        with _at(self.precision):
            y = self.fc(y.to(self.fc[0].weight.dtype))
        return x * y[:, :, None, None].to(x.dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1(x4) with projection shortcut
    (reference: resnet.py:44-71); `se_reduction` > 0 gates the branch with
    an SELayer before the residual add."""
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 se_reduction: int = 0, precision: Optional[str] = None):
        super().__init__()
        out_ch = planes * self.expansion
        self.stride = stride
        self.precision = _check_precision(precision)
        self.conv1, self.bn1 = _conv_bn(in_planes, planes, 1)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3, stride)
        self.conv3, self.bn3 = _conv_bn(planes, out_ch, 1)
        if se_reduction:
            self.se = SELayer(out_ch, se_reduction, precision)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != out_ch:
            self.shortcut = nn.Sequential(*_conv_bn(in_planes, out_ch, 1,
                                                    stride))

    def forward(self, x: torch.Tensor,
                in_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`in_mask` [B, T_in]: the valid-time mask at the INPUT
        resolution, applied after the first activation so that the 3x3
        conv reads exact zeros past the valid frames."""
        with _at(self.precision):
            return self._forward(x, in_mask)

    def _forward(self, x, in_mask):
        y = _bn_relu_to_conv(self.bn1, _conv(self.conv1, x), in_mask)
        y = _bn_relu_to_conv(self.bn2, _conv(self.conv2, y))
        y = _bn(self.bn3, _conv(self.conv3, y))
        if hasattr(self, "se"):
            out_mask = None
            if in_mask is not None:
                out_mask = in_mask[:, ::self.stride][:, :y.shape[3]]
            y = self.se(y, mask=out_mask)
        if len(self.shortcut):
            x = _bn(self.shortcut[1], _conv(self.shortcut[0], x))
        return F.relu(y + x)


class BasicBlock(nn.Module):
    """3x3(stride) -> 3x3 with projection shortcut (reference:
    resnet.py:17-41); `se_reduction` as in Bottleneck."""
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 se_reduction: int = 0, precision: Optional[str] = None):
        super().__init__()
        self.stride = stride
        self.precision = _check_precision(precision)
        self.conv1, self.bn1 = _conv_bn(in_planes, planes, 3, stride)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3)
        if se_reduction:
            self.se = SELayer(planes, se_reduction, precision)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(*_conv_bn(in_planes, planes, 1,
                                                    stride))

    def forward(self, x: torch.Tensor,
                out_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`out_mask` [B, T_out]: the valid-time mask at the OUTPUT
        resolution, applied between the two 3x3 convs."""
        with _at(self.precision):
            return self._forward(x, out_mask)

    def _forward(self, x, out_mask):
        y = _bn_relu_to_conv(self.bn1, _conv(self.conv1, x), out_mask)
        y = _bn(self.bn2, _conv(self.conv2, y))
        if hasattr(self, "se"):
            y = self.se(y, mask=out_mask)
        if len(self.shortcut):
            x = _bn(self.shortcut[1], _conv(self.shortcut[0], x))
        return F.relu(y + x)


def pooled_freq(feat_dim: int) -> int:
    """Frequency rows left after the three stride-2 stages."""
    for _ in range(3):
        feat_dim = (feat_dim + 1) // 2
    return feat_dim


class ResNetXVector(nn.Module):
    """[B, F, T] log-fbanks -> [B, embed_dim] x-vectors. Built in eval
    mode (inference: BatchNorm reads its running statistics)."""

    def __init__(self, block: type = Bottleneck,
                 num_blocks: Sequence[int] = (3, 4, 23, 3),
                 m_channels: int = 32, feat_dim: int = 64,
                 embed_dim: int = 256, se_reduction: int = 0,
                 dtype: torch.dtype = torch.float32,
                 precision: Optional[str] = None):
        super().__init__()
        self.precision = _check_precision(precision)
        self.block = block
        self.num_blocks = tuple(num_blocks)
        self.m_channels = m_channels
        self.feat_dim = feat_dim
        self.embed_dim = embed_dim
        self.se_reduction = se_reduction
        self.dtype = dtype
        self.conv1, self.bn1 = _conv_bn(1, m_channels, 3)
        in_planes = m_channels
        for li, (n, stride) in enumerate(zip(self.num_blocks, (1, 2, 2, 2)),
                                         start=1):
            planes = m_channels * 2 ** (li - 1)
            blocks = []
            for bi in range(n):
                blocks.append(block(in_planes, planes,
                                    stride if bi == 0 else 1, se_reduction,
                                    precision))
                in_planes = planes * block.expansion
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.embedding = nn.Linear(2 * in_planes * pooled_freq(feat_dim),
                                   embed_dim)
        for m in self.modules():
            if isinstance(m, nn.Conv2d) or (isinstance(m, nn.Linear)
                                            and m is not self.embedding):
                m.to(dtype)
        self.eval()

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, F, T] log-fbanks (not modified). `lengths` ([B] int,
        optional) marks each example's valid time prefix: frames past it
        are zeroed after every stage and the pool reads valid frames only,
        so a zero-padded example gives its unpadded embedding."""
        with _at(self.precision):
            return self._forward(x, lengths)

    def _forward(self, x, lengths):
        y = x[:, None]                                  # [B, 1, F, T]
        cur_len = lengths
        mask = _time_mask(cur_len, y.shape[3])
        y = _mask_time(F.relu(_bn(self.bn1, _conv(self.conv1, y))), mask)
        for li in range(1, 5):
            for bi, blk in enumerate(getattr(self, f"layer{li}")):
                halves = blk.stride == 2 and cur_len is not None
                in_mask = mask
                if halves:
                    # out_t = floor((t-1)/2)+1 = ceil(t/2) for 3x3/s2/p1
                    cur_len = (cur_len + 1) // 2
                if isinstance(blk, Bottleneck):
                    y = blk(y, in_mask=in_mask)         # 3x3 at input res
                else:
                    if halves:                          # 3x3 at output res
                        mask = _time_mask(cur_len, (y.shape[3] + 1) // 2)
                    y = blk(y, out_mask=mask)
                if halves:
                    mask = _time_mask(cur_len, y.shape[3])
                y = _mask_time(y, mask)
        # statistics pooling over time in float32 (resnet.py:138-142)
        y = y.float()
        if cur_len is None:
            mean = y.mean(dim=3)                        # [B, C, F']
            meansq = (y * y).mean(dim=3)
        else:
            denom = cur_len[:, None, None].float()
            mean = y.sum(dim=3) / denom
            meansq = (y * y).sum(dim=3) / denom
        std = torch.sqrt(meansq - mean ** 2 + 1e-10)
        flat = torch.cat([mean.flatten(1), std.flatten(1)], dim=1)
        return self.embedding(flat)


def resnet101(feat_dim: int = 64, embed_dim: int = 256,
              dtype: torch.dtype = torch.float32,
              precision: Optional[str] = None) -> ResNetXVector:
    """The reference's shipped extractor architecture
    (resnet.py:148-149)."""
    return ResNetXVector(Bottleneck, (3, 4, 23, 3), feat_dim=feat_dim,
                         embed_dim=embed_dim, dtype=dtype,
                         precision=precision)


def resnet34(feat_dim: int = 64, embed_dim: int = 256,
             dtype: torch.dtype = torch.float32,
             precision: Optional[str] = None) -> ResNetXVector:
    return ResNetXVector(BasicBlock, (3, 4, 6, 3), feat_dim=feat_dim,
                         embed_dim=embed_dim, dtype=dtype,
                         precision=precision)


def se_resnet34(feat_dim: int = 64, embed_dim: int = 256,
                reduction: int = 16,
                dtype: torch.dtype = torch.float32,
                precision: Optional[str] = None) -> ResNetXVector:
    """SE-ResNet34: BasicBlock stages with the reference's SELayer gate
    (resnet.py:74-89) before each residual add."""
    return ResNetXVector(BasicBlock, (3, 4, 6, 3), feat_dim=feat_dim,
                         embed_dim=embed_dim, se_reduction=reduction,
                         dtype=dtype, precision=precision)


# ---------------------------------------------------------------------------
# state dicts: reference checkpoints, vbx_tpu's Flax variables, BN folding
# ---------------------------------------------------------------------------

_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _tensor(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else \
        torch.from_numpy(np.array(v))


def convert_torch_state_dict(sd: Dict[str, Any], num_blocks=(3, 4, 23, 3)
                             ) -> Dict[str, torch.Tensor]:
    """Check a reference-format torch state dict (resnet.py module names,
    possibly `module.`-prefixed, as AMI_run.sh checkpoints are) against
    the architecture with `num_blocks`, and return the port's state dict.

    Every extractor tensor must be consumed: a depth-mismatched checkpoint
    (a ResNet101 one read with ResNet34 block counts) raises rather than
    drop layers silently. Tensors outside the extractor modules (a
    classification head saved at training time, ...) only warn, as the
    reference loads with strict=False (predict.py:124)."""
    sd = {k.split("module.", 1)[-1]: v for k, v in sd.items()}
    unused = {k for k in sd if not k.endswith("num_batches_tracked")}
    out: Dict[str, torch.Tensor] = {}

    def take(key):
        unused.discard(key)
        out[key] = _tensor(sd[key])

    def take_bn(prefix):
        for k in _BN_KEYS:
            take(f"{prefix}.{k}")
        nbt = f"{prefix}.num_batches_tracked"
        out[nbt] = _tensor(sd[nbt]) if nbt in sd else \
            torch.tensor(0, dtype=torch.long)

    take("conv1.weight")
    take_bn("bn1")
    for li, n in enumerate(num_blocks, start=1):
        for bi in range(n):
            src = f"layer{li}.{bi}"
            convs = [k for k in ("conv1", "conv2", "conv3")
                     if f"{src}.{k}.weight" in sd]
            if not convs:
                raise ValueError(
                    f"state dict has no weights for block {src!r}: the "
                    f"checkpoint is shallower than num_blocks={num_blocks} "
                    f"(wrong arch?)")
            for c in convs:
                take(f"{src}.{c}.weight")
                take_bn(f"{src}.{c.replace('conv', 'bn')}")
            if f"{src}.se.fc.0.weight" in sd:
                take(f"{src}.se.fc.0.weight")
                take(f"{src}.se.fc.2.weight")
            if f"{src}.shortcut.0.weight" in sd:
                take(f"{src}.shortcut.0.weight")
                take_bn(f"{src}.shortcut.1")
    take("embedding.weight")
    take("embedding.bias")
    if unused:
        extractor_pat = re.compile(
            r"(layer[1-4]\.\d+\.|conv1\.|bn1\.|embedding\.)")
        depth_issues = {k for k in unused if extractor_pat.match(k)}
        if depth_issues:
            raise ValueError(
                f"{len(depth_issues)} extractor tensor(s) not consumed by "
                f"the conversion (checkpoint deeper than "
                f"num_blocks={num_blocks}?): {sorted(depth_issues)[:6]}")
        warnings.warn(
            f"ignoring {len(unused)} non-extractor state-dict tensor(s) "
            f"(training-time extras, reference loads strict=False): "
            f"{sorted(unused)[:4]}", stacklevel=2)
    return out


def state_dict_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """vbx_tpu's Flax variables ({'params', 'batch_stats'}, numpy or jax
    arrays) -> the port's state dict: conv kernels HWIO -> OIHW, Dense
    [in, out] -> Linear [out, in], BatchNorm scale/bias/mean/var ->
    weight/bias/running_mean/running_var. The inverse of vbx_tpu's
    convert_torch_state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def conv(dst, p):
        out[f"{dst}.weight"] = t(np.transpose(np.asarray(p["kernel"]),
                                              (3, 2, 0, 1)))

    def bn(dst, p, s):
        for k, v in zip(_BN_KEYS, (p["scale"], p["bias"], s["mean"],
                                   s["var"])):
            out[f"{dst}.{k}"] = t(v)
        out[f"{dst}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"], stats["bn1"])
    blocks = sorted((k for k in params if k.startswith("layer")),
                    key=lambda k: tuple(int(i) for i in k[5:].split("_")))
    for name in blocks:
        p, s = params[name], stats[name]
        dst = "layer{}.{}".format(*name[5:].split("_"))
        for c in ("conv1", "conv2", "conv3"):
            if c in p:
                conv(f"{dst}.{c}", p[c])
                b = c.replace("conv", "bn")
                bn(f"{dst}.{b}", p[b], s[b])
        if "se" in p:
            out[f"{dst}.se.fc.0.weight"] = t(np.asarray(
                p["se"]["fc1"]["kernel"]).T)
            out[f"{dst}.se.fc.2.weight"] = t(np.asarray(
                p["se"]["fc2"]["kernel"]).T)
        if "shortcut_conv" in p:
            conv(f"{dst}.shortcut.0", p["shortcut_conv"])
            bn(f"{dst}.shortcut.1", p["shortcut_bn"], s["shortcut_bn"])
    out["embedding.weight"] = t(np.asarray(params["embedding"]["kernel"]).T)
    out["embedding.bias"] = t(params["embedding"]["bias"])
    return out


def _arch(arch: str, feat_dim: int, embed_dim: int, dtype) -> ResNetXVector:
    if arch == "ResNet101":
        return resnet101(feat_dim, embed_dim, dtype=dtype)
    if arch == "ResNet34":
        return resnet34(feat_dim, embed_dim, dtype=dtype)
    raise ValueError(f"unknown arch {arch!r} (ResNet101 or ResNet34)")


def load_torch_checkpoint(path: str, feat_dim: int = 64,
                          embed_dim: int = 256,
                          dtype: torch.dtype = torch.float32,
                          arch: str = "ResNet101") -> ResNetXVector:
    """Load a reference .pth/.pt checkpoint (a state dict, a dict holding
    one under 'state_dict', or a whole pickled model) into the port's
    model of `arch` (ResNet101 or ResNet34), on the CPU.

    The file is unpickled with weights_only=False, as vbx_tpu and the
    reference do, since `--model-file` checkpoints pickle a whole model:
    load only files you trust."""
    model = _arch(arch, feat_dim, embed_dim, dtype)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else \
        ckpt.state_dict()
    model.load_state_dict(convert_torch_state_dict(
        sd, num_blocks=model.num_blocks))
    return model


def fold_batchnorm(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold inference-mode BatchNorm into per-channel scale+bias in a state
    dict: weight' = weight/sqrt(var+eps), bias' = bias - mean*weight',
    mean 0, var 1-eps. The result loads into the same model and gives the
    same embeddings (to rounding)."""
    out = dict(sd)
    for key in sd:
        if not key.endswith(".running_mean"):
            continue
        p = key[:-len("running_mean")]
        var = sd[p + "running_var"].double()
        scale = sd[p + "weight"].double() / torch.sqrt(var + _BN_EPS)
        dtype = sd[p + "weight"].dtype
        out[p + "weight"] = scale.to(dtype)
        out[p + "bias"] = (sd[p + "bias"].double()
                           - sd[key].double() * scale).to(dtype)
        out[key] = torch.zeros_like(sd[key])
        out[p + "running_var"] = torch.full_like(var, 1.0 - _BN_EPS).to(
            sd[p + "running_var"].dtype)
    return out
