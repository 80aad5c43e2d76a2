"""WavLM Base Plus SV: speaker embeddings from raw 16 kHz samples
(Hugging Face's `WavLMForXVector`, microsoft/wavlm-base-plus-sv; WavLM,
arXiv:2110.13900), as torch modules under Hugging Face's parameter names.

The layers, at the published widths (`WavLMWidths()`):
- conv feature encoder: 7 bias-free Conv1d of 512 channels, kernels
  (10, 3, 3, 3, 3, 2, 2), strides (5, 2, 2, 2, 2, 2, 2), GELU after each;
  layer 0 alone has GroupNorm(512 groups), each channel normalized over
  time. 23,040 samples (a 1.44 s window) give 71 frames;
- feature projection: LayerNorm(512), Linear(512 -> 768);
- positional conv: Conv1d(768, 768, kernel 128, padding 64, 16 groups)
  with weight norm over dim 2 (folded into one weight when a checkpoint is
  loaded), its last frame dropped, GELU; added, then LayerNorm;
- 12 post-LN encoder layers (768 wide, 12 heads of 64, FFN 3072, GELU)
  whose attention adds WavLM's gated relative position bias: layer 0's
  `rel_attn_embed` [320, 12] over 160 buckets a sign (exact below 80,
  log-spaced to 800), gated in every layer by `gru_rel_pos_linear` (64 ->
  8) of the layer's input, per head and query;
- a softmax-weighted sum of the 13 hidden states (the post-LN embedding
  and the 12 layer outputs);
- head: projector Linear(768 -> 512), 5 TDNN layers (512 x 4, 1500;
  kernels 5, 3, 3, 1, 1; dilations 1, 2, 3, 1, 1; ReLU, no padding),
  mean and unbiased std over time, Linear(3000 -> 512): the embedding.
  Hugging Face's `classifier` and `objective` are training heads and are
  not held.

`forward(samples [B, N], lengths)` takes `lengths` in samples and runs
each row as if alone and unpadded: layer 0's GroupNorm takes its
statistics over the row's valid conv frames; frames past the row's count
are zeroed before the positional conv; attention masks padded keys; the
pool takes the valid TDNN frames, counted from the dilated kernels'
context (14 frames). Hugging Face's `_get_tdnn_output_lengths` leaves the
dilations out (8 frames), so its own padded batches pool 6 frames past the
valid ones; the port counts the frames the convolutions produce, which is
what a lone run pools. `lengths=None` masks nothing.

A row needs 16 conv frames (`min_samples` = 5,130 samples): the TDNN's 14
frames of context then leave two for the unbiased std (Hugging Face gives
NaN at 15 frames and raises below). The extractor tiles a shorter window
up to `min_samples` before it runs the model (a departure from Hugging
Face, which has no such rule).

The extractor runs a file's windows stage by stage (`frontend`,
`encode`, `head`); `counters()` says how many windows, masked, tiled and
filler slots it ran.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Hugging Face keys that are not part of the embedding path
DROPPED_PREFIXES = ("classifier.", "objective.")
DROPPED_KEYS = ("wavlm.masked_spec_embed",)
POS_CONV = "wavlm.encoder.pos_conv_embed.conv"
_WEIGHT_NORM = {
    (f"{POS_CONV}.weight_g", f"{POS_CONV}.weight_v"),
    (f"{POS_CONV}.parametrizations.weight.original0",
     f"{POS_CONV}.parametrizations.weight.original1"),
}


@dataclasses.dataclass(frozen=True)
class WavLMWidths:
    """The architecture's sizes under `WavLMConfig`'s names; the defaults
    are microsoft/wavlm-base-plus-sv's config.json."""

    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layer_norm_eps: float = 1e-5
    tdnn_dim: Tuple[int, ...] = (512, 512, 512, 512, 1500)
    tdnn_kernel: Tuple[int, ...] = (5, 3, 3, 1, 1)
    tdnn_dilation: Tuple[int, ...] = (1, 2, 3, 1, 1)
    xvector_output_dim: int = 512

    @classmethod
    def from_dict(cls, d: Mapping) -> "WavLMWidths":
        """The widths named in `d` (a configuration's `widths`; other keys
        are ignored), lists as tuples."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in names})

    @property
    def tdnn_context(self) -> int:
        return sum((k - 1) * d for k, d in zip(self.tdnn_kernel,
                                               self.tdnn_dilation))


def conv_frames(samples, widths: WavLMWidths):
    """Frames the conv encoder makes of `samples` (int or int tensor)."""
    for k, s in zip(widths.conv_kernel, widths.conv_stride):
        samples = (samples - k) // s + 1
    return samples


def min_samples(widths: WavLMWidths) -> int:
    """The fewest samples whose TDNN output has two frames."""
    n = 1
    while conv_frames(n, widths) < widths.tdnn_context + 2:
        n += 1
    return n


# -- counters ----------------------------------------------------------------

_COUNT_LOCK = threading.Lock()
# cumulative over every waveform batch the extractor ran: windows embedded,
# those carrying a length (tails), those tiled up to min_samples, their own
# samples (before tiling), batches, and filler slots of the last batches
_COUNTERS = dict.fromkeys(("windows", "masked_windows", "tiled_windows",
                           "samples", "batches", "pad_slots"), 0)


def counters(since: Optional[dict] = None) -> dict:
    """A snapshot of the waveform path's cumulative counters; given an
    earlier snapshot, the counts since it."""
    with _COUNT_LOCK:
        now = dict(_COUNTERS)
    if since is None:
        return now
    return {k: v - since[k] for k, v in now.items()}


def add_counts(**counts: int) -> None:
    with _COUNT_LOCK:
        for k, v in counts.items():
            _COUNTERS[k] += int(v)


# -- relative position buckets ----------------------------------------------

_BUCKETS: Dict[Tuple[int, int, int, str], torch.Tensor] = {}


def relative_buckets(t: int, num_buckets: int, max_distance: int,
                     device) -> torch.Tensor:
    """[t, t] bucket of key j for query i (`_relative_positions_bucket`),
    built once for each (t, buckets, distance, device) and kept."""
    key = (t, num_buckets, max_distance, str(device))
    table = _BUCKETS.get(key)
    if table is None:
        pos = torch.arange(t, dtype=torch.long)
        rel = pos[None, :] - pos[:, None]
        half = num_buckets // 2
        out = (rel > 0).long() * half
        rel = rel.abs()
        exact = half // 2
        large = (exact + torch.log(rel.float() / exact)
                 / math.log(max_distance / exact) * (half - exact)).long()
        large = torch.clamp(large, max=half - 1)
        table = (out + torch.where(rel < exact, rel, large)).to(device)
        _BUCKETS[key] = table
    return table


# -- modules under Hugging Face's names -------------------------------------

class _ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, s: int, norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, stride=s, bias=False)
        if norm:
            self.layer_norm = nn.GroupNorm(cout, cout, affine=True)


class _FeatureEncoder(nn.Module):
    def __init__(self, w: WavLMWidths):
        super().__init__()
        cin = [1] + list(w.conv_dim[:-1])
        self.conv_layers = nn.ModuleList(
            _ConvLayer(a, b, k, s, i == 0) for i, (a, b, k, s) in enumerate(
                zip(cin, w.conv_dim, w.conv_kernel, w.conv_stride)))


class _FeatureProjection(nn.Module):
    def __init__(self, w: WavLMWidths):
        super().__init__()
        self.layer_norm = nn.LayerNorm(w.conv_dim[-1], eps=w.layer_norm_eps)
        self.projection = nn.Linear(w.conv_dim[-1], w.hidden_size)


class _PosConv(nn.Module):
    def __init__(self, w: WavLMWidths):
        super().__init__()
        self.conv = nn.Conv1d(w.hidden_size, w.hidden_size,
                              w.num_conv_pos_embeddings,
                              padding=w.num_conv_pos_embeddings // 2,
                              groups=w.num_conv_pos_embedding_groups)


class _Attention(nn.Module):
    def __init__(self, w: WavLMWidths, has_bias: bool):
        super().__init__()
        d, h = w.hidden_size, w.num_attention_heads
        self.heads = h
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, h, 1, 1))
        self.gru_rel_pos_linear = nn.Linear(d // h, 8)
        if has_bias:
            self.rel_attn_embed = nn.Embedding(w.num_buckets, h)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                key_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x [B, T, D]; bias [H, T, T]; key_mask [B, 1, 1, T] additive
        (0 or -inf) or None."""
        B, T, D = x.shape
        H = self.heads

        def heads(y):
            return y.view(B, T, H, D // H).transpose(1, 2)   # [B, H, T, d]

        xh = heads(x)
        # the gate of each head and query, from the layer's input
        g = self.gru_rel_pos_linear(xh).view(B, H, T, 2, 4).sum(-1)
        a, b = torch.sigmoid(g).unbind(-1)
        gate = a * (b * self.gru_rel_pos_const[..., 0] - 1.0) + 2.0
        mask = gate[..., None] * bias                         # [B, H, T, T]
        if key_mask is not None:
            mask = mask + key_mask
        q, k, v = (heads(p(x)) for p in (self.q_proj, self.k_proj,
                                          self.v_proj))
        scores = torch.baddbmm(mask.view(B * H, T, T),
                               q.reshape(B * H, T, -1),
                               k.reshape(B * H, T, -1).transpose(1, 2),
                               alpha=(D // H) ** -0.5)
        o = torch.bmm(torch.softmax(scores, dim=-1), v.reshape(B * H, T, -1))
        return self.out_proj(o.view(B, H, T, -1).transpose(1, 2)
                             .reshape(B, T, D))


class _FeedForward(nn.Module):
    def __init__(self, w: WavLMWidths):
        super().__init__()
        self.intermediate_dense = nn.Linear(w.hidden_size,
                                            w.intermediate_size)
        self.output_dense = nn.Linear(w.intermediate_size, w.hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class _EncoderLayer(nn.Module):
    def __init__(self, w: WavLMWidths, has_bias: bool):
        super().__init__()
        self.attention = _Attention(w, has_bias)
        self.layer_norm = nn.LayerNorm(w.hidden_size, eps=w.layer_norm_eps)
        self.feed_forward = _FeedForward(w)
        self.final_layer_norm = nn.LayerNorm(w.hidden_size,
                                             eps=w.layer_norm_eps)

    def forward(self, x, bias, key_mask):
        x = self.layer_norm(x + self.attention(x, bias, key_mask))
        return self.final_layer_norm(x + self.feed_forward(x))


class _Encoder(nn.Module):
    def __init__(self, w: WavLMWidths):
        super().__init__()
        self.pos_conv_embed = _PosConv(w)
        self.layer_norm = nn.LayerNorm(w.hidden_size, eps=w.layer_norm_eps)
        self.layers = nn.ModuleList(_EncoderLayer(w, i == 0)
                                    for i in range(w.num_hidden_layers))


class _Body(nn.Module):
    def __init__(self, w: WavLMWidths):
        super().__init__()
        self.feature_extractor = _FeatureEncoder(w)
        self.feature_projection = _FeatureProjection(w)
        self.encoder = _Encoder(w)


class _TDNN(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, d: int):
        super().__init__()
        self.kernel = nn.Linear(cin * k, cout)
        self.k, self.d = k, d

    def forward(self, x):                                    # [B, C, T]
        w = self.kernel.weight
        w = w.view(w.shape[0], self.k, -1).transpose(1, 2)
        return F.relu(F.conv1d(x, w, self.kernel.bias, dilation=self.d))


def _valid(frames: Optional[torch.Tensor], t: int) -> Optional[torch.Tensor]:
    """[B, t] True where a frame lies within its row's count."""
    if frames is None:
        return None
    return torch.arange(t, device=frames.device)[None, :] < frames[:, None]


class WavLMXVector(nn.Module):
    """WavLM Base Plus SV's embedding path (module docstring)."""

    input_kind = "waveform"   # XVectorExtractor feeds it raw samples

    def __init__(self, widths: WavLMWidths = WavLMWidths()):
        super().__init__()
        w = self.widths = widths
        self.wavlm = _Body(w)
        self.layer_weights = nn.Parameter(
            torch.ones(w.num_hidden_layers + 1) / (w.num_hidden_layers + 1))
        self.projector = nn.Linear(w.hidden_size, w.tdnn_dim[0])
        cin = [w.tdnn_dim[0]] + list(w.tdnn_dim[:-1])
        self.tdnn = nn.ModuleList(_TDNN(a, b, k, d) for a, b, k, d in zip(
            cin, w.tdnn_dim, w.tdnn_kernel, w.tdnn_dilation))
        self.feature_extractor = nn.Linear(2 * w.tdnn_dim[-1],
                                           w.xvector_output_dim)
        self.embed_dim = w.xvector_output_dim
        self.min_samples = min_samples(w)
        self.eval()

    # -- stages ---------------------------------------------------------------

    def frontend(self, samples: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """samples [B, N] -> (projected conv features [B, T, hidden], each
        row's frame count [B] or None)."""
        w = self.widths
        y = samples[:, None]
        n = lengths
        for i, layer in enumerate(self.wavlm.feature_extractor.conv_layers):
            y = layer.conv(y)
            if n is not None:
                n = (n - w.conv_kernel[i]) // w.conv_stride[i] + 1
            if i == 0:
                gn = layer.layer_norm
                if n is None:
                    y = F.group_norm(y, gn.num_groups, gn.weight, gn.bias,
                                     gn.eps)
                else:
                    y = self._masked_group_norm(y, n, gn)
            y = F.gelu(y)
        fp = self.wavlm.feature_projection
        return fp.projection(fp.layer_norm(y.transpose(1, 2))), n

    @staticmethod
    def _masked_group_norm(y, n, gn):
        """GroupNorm of one channel a group over each row's first n frames
        (the frames past them are normalized with the same statistics and
        read by no valid frame later)."""
        m = _valid(n, y.shape[-1])[:, None, :].to(y.dtype)
        cnt = n.to(y.dtype)[:, None, None]
        mean = (y * m).sum(-1, keepdim=True) / cnt
        var = (((y - mean) * m) ** 2).sum(-1, keepdim=True) / cnt
        y = (y - mean) * torch.rsqrt(var + gn.eps)
        return y * gn.weight[:, None] + gn.bias[:, None]

    def encode(self, hidden: torch.Tensor,
               frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, T, hidden] -> the softmax-weighted sum of the 13 hidden
        states [B, T, hidden]."""
        w = self.widths
        enc = self.wavlm.encoder
        B, T, _ = hidden.shape
        valid = _valid(frames, T)
        key_mask = None
        if valid is not None:
            hidden = hidden * valid[..., None].to(hidden.dtype)
            key_mask = torch.zeros((B, 1, 1, T), dtype=hidden.dtype,
                                   device=hidden.device).masked_fill(
                ~valid[:, None, None, :], float("-inf"))
        pos = enc.pos_conv_embed.conv(hidden.transpose(1, 2))
        if w.num_conv_pos_embeddings % 2 == 0:
            pos = pos[..., :-1]
        x = enc.layer_norm(hidden + F.gelu(pos).transpose(1, 2))
        att0 = enc.layers[0].attention
        bias = att0.rel_attn_embed(relative_buckets(
            T, w.num_buckets, w.max_bucket_distance, x.device)).permute(
            2, 0, 1)                                         # [H, T, T]
        lw = torch.softmax(self.layer_weights, dim=-1)
        out = x * lw[0]
        for i, layer in enumerate(enc.layers, start=1):
            x = layer(x, bias, key_mask)
            out = out + x * lw[i]
        return out

    def head(self, hidden: torch.Tensor,
             frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Weighted hidden states [B, T, hidden] -> embeddings [B, 512]."""
        y = self.projector(hidden).transpose(1, 2)           # [B, C, T]
        for layer in self.tdnn:
            y = layer(y)
        if frames is None:
            mean, std = y.mean(-1), y.std(-1)
        else:
            n = frames - self.widths.tdnn_context
            m = _valid(n, y.shape[-1])[:, None, :].to(y.dtype)
            cnt = n.to(y.dtype)[:, None]
            mean = (y * m).sum(-1) / cnt
            std = torch.sqrt((((y - mean[..., None]) * m) ** 2).sum(-1)
                             / (cnt - 1))
        return self.feature_extractor(torch.cat([mean, std], dim=-1))

    def forward(self, samples: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """samples [B, N] float32 in [-1, 1); lengths [B] samples or None
        -> embeddings [B, xvector_output_dim]."""
        hidden, frames = self.frontend(samples, lengths)
        return self.head(self.encode(hidden, frames), frames)


# -- checkpoints -------------------------------------------------------------

def convert_wavlm_state_dict(sd: Mapping[str, torch.Tensor],
                             model: WavLMXVector) -> Dict[str, torch.Tensor]:
    """A Hugging Face `WavLMForXVector` state dict -> `model`'s: the
    positional conv's weight norm (`weight_g` / `weight_v`, or
    `parametrizations.weight.original0` / `original1`) folded into one
    weight (g v / |v|, the norm over every dim but 2), the training heads
    and `masked_spec_embed` dropped. Any other key missing or left over,
    or a shape that differs, raises."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.startswith(DROPPED_PREFIXES) or k in DROPPED_KEYS:
            continue
        out[k] = v.detach() if isinstance(v, torch.Tensor) else \
            torch.as_tensor(v)
    for g_key, v_key in _WEIGHT_NORM:
        if g_key in out or v_key in out:
            g, v = out.pop(g_key), out.pop(v_key)
            out[f"{POS_CONV}.weight"] = torch._weight_norm(
                v.double(), g.double(), 2).to(v.dtype)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing, extra = sorted(set(want) - set(out)), sorted(set(out) - set(want))
    if missing or extra:
        raise ValueError(f"WavLM state dict: missing {missing[:6]}, "
                         f"unexpected {extra[:6]}")
    bad = [k for k in want if tuple(out[k].shape) != want[k]]
    if bad:
        raise ValueError(f"WavLM state dict: shapes differ for {bad[:6]} "
                         f"({[tuple(out[k].shape) for k in bad[:6]]} "
                         f"against {[want[k] for k in bad[:6]]})")
    return out


def load_wavlm_checkpoint(path: str, widths: WavLMWidths = WavLMWidths()
                          ) -> WavLMXVector:
    """The model of `widths` with the weights of a Hugging Face
    `WavLMForXVector` checkpoint: a torch state dict (`pytorch_model.bin`,
    read with weights_only=True) or, where the safetensors package
    imports, a `.safetensors` file; on the CPU."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
    model = WavLMXVector(widths)
    model.load_state_dict(convert_wavlm_state_dict(sd, model))
    return model
