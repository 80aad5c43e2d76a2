"""Plain WavLM Base Plus SV, the reference the `wavlm_base_plus_sv`
extraction cell is judged against: Hugging Face's `WavLMForXVector`
embedding path (transformers/models/wavlm/modeling_wavlm.py) in plain
torch float32 over a state dict under Hugging Face's parameter names, one
window at a time, no masks or batching, TF32 off unless `embed` is asked
for it (the control). A frozen copy of tests/wavlm_plain.py, with the
window cutting of the benchmark's extraction cells added (`samples_of`).
It imports nothing of the program.

Departure from Hugging Face, the program's too: a window shorter than
`min_samples(w)` (16 conv frames, so that the TDNN's context leaves two
frames for the unbiased std) is tiled up to that length.
"""

import functools
import math
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

PUBLISHED = {
    "conv_dim": [512] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
    "conv_stride": [5, 2, 2, 2, 2, 2, 2], "hidden_size": 768,
    "num_hidden_layers": 12, "num_attention_heads": 12,
    "intermediate_size": 3072, "num_conv_pos_embeddings": 128,
    "num_conv_pos_embedding_groups": 16, "num_buckets": 320,
    "max_bucket_distance": 800, "layer_norm_eps": 1e-5,
    "tdnn_dim": [512, 512, 512, 512, 1500], "tdnn_kernel": [5, 3, 3, 1, 1],
    "tdnn_dilation": [1, 2, 3, 1, 1], "xvector_output_dim": 512,
}
POS = "wavlm.encoder.pos_conv_embed.conv"
G_V = ((f"{POS}.parametrizations.weight.original0",
        f"{POS}.parametrizations.weight.original1"),
       (f"{POS}.weight_g", f"{POS}.weight_v"))


def param_shapes(w: Mapping) -> Dict[str, tuple]:
    """Every parameter of the embedding path under Hugging Face's names
    (the positional conv's weight norm in the parametrizations layout)."""
    out = {}
    cin = 1
    for i, c in enumerate(w["conv_dim"]):
        p = f"wavlm.feature_extractor.conv_layers.{i}"
        out[f"{p}.conv.weight"] = (c, cin, w["conv_kernel"][i])
        if i == 0:
            out[f"{p}.layer_norm.weight"] = (c,)
            out[f"{p}.layer_norm.bias"] = (c,)
        cin = c
    d, h = w["hidden_size"], w["num_attention_heads"]
    out["wavlm.feature_projection.layer_norm.weight"] = (cin,)
    out["wavlm.feature_projection.layer_norm.bias"] = (cin,)
    out["wavlm.feature_projection.projection.weight"] = (d, cin)
    out["wavlm.feature_projection.projection.bias"] = (d,)
    k = w["num_conv_pos_embeddings"]
    out[G_V[0][0]] = (1, 1, k)
    out[G_V[0][1]] = (d, d // w["num_conv_pos_embedding_groups"], k)
    out[f"{POS}.bias"] = (d,)
    out["wavlm.encoder.layer_norm.weight"] = (d,)
    out["wavlm.encoder.layer_norm.bias"] = (d,)
    for i in range(w["num_hidden_layers"]):
        p = f"wavlm.encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[f"{p}.attention.{n}.weight"] = (d, d)
            out[f"{p}.attention.{n}.bias"] = (d,)
        out[f"{p}.attention.gru_rel_pos_const"] = (1, h, 1, 1)
        out[f"{p}.attention.gru_rel_pos_linear.weight"] = (8, d // h)
        out[f"{p}.attention.gru_rel_pos_linear.bias"] = (8,)
        if i == 0:
            out[f"{p}.attention.rel_attn_embed.weight"] = (w["num_buckets"],
                                                           h)
        for n in ("layer_norm", "final_layer_norm"):
            out[f"{p}.{n}.weight"] = (d,)
            out[f"{p}.{n}.bias"] = (d,)
        f = w["intermediate_size"]
        out[f"{p}.feed_forward.intermediate_dense.weight"] = (f, d)
        out[f"{p}.feed_forward.intermediate_dense.bias"] = (f,)
        out[f"{p}.feed_forward.output_dense.weight"] = (d, f)
        out[f"{p}.feed_forward.output_dense.bias"] = (d,)
    out["layer_weights"] = (w["num_hidden_layers"] + 1,)
    t = w["tdnn_dim"]
    out["projector.weight"] = (t[0], d)
    out["projector.bias"] = (t[0],)
    cin = t[0]
    for i, (c, kk) in enumerate(zip(t, w["tdnn_kernel"])):
        out[f"tdnn.{i}.kernel.weight"] = (c, cin * kk)
        out[f"tdnn.{i}.kernel.bias"] = (c,)
        cin = c
    out["feature_extractor.weight"] = (w["xvector_output_dim"], 2 * t[-1])
    out["feature_extractor.bias"] = (w["xvector_output_dim"],)
    return out


def pos_conv_weight(p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The positional conv's weight: g v / |v|, the norm over dims 0 and 1
    (weight_norm with dim=2)."""
    for g_key, v_key in G_V:
        if g_key in p:
            g, v = p[g_key], p[v_key]
            return g * v / torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True))
    return p[f"{POS}.weight"]


@functools.lru_cache(maxsize=None)
def buckets(t: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """_relative_positions_bucket of key j - query i, [t, t]."""
    half = num_buckets // 2
    exact = half // 2
    out = torch.zeros((t, t), dtype=torch.long)
    for i in range(t):
        for j in range(t):
            r = j - i
            b = half if r > 0 else 0
            r = abs(r)
            if r < exact:
                b += r
            else:
                x = torch.log(torch.tensor(float(r)) / exact)
                x = exact + x / math.log(max_distance / exact) * (half - exact)
                b += min(int(x), half - 1)
            out[i, j] = b
    return out


def layer_norm(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


def forward(p: Mapping[str, torch.Tensor], w: Mapping,
            x: torch.Tensor) -> torch.Tensor:
    """The embedding [xvector_output_dim] of one window x [N] float32."""
    eps = w["layer_norm_eps"]
    y = x[None, None]
    for i, s in enumerate(w["conv_stride"]):
        pre = f"wavlm.feature_extractor.conv_layers.{i}"
        y = F.conv1d(y, p[f"{pre}.conv.weight"], stride=s)
        if i == 0:
            y = F.group_norm(y, y.shape[1], p[f"{pre}.layer_norm.weight"],
                             p[f"{pre}.layer_norm.bias"], 1e-5)
        y = F.gelu(y)
    y = layer_norm(y[0].T, p, "wavlm.feature_projection.layer_norm", eps)
    h = y @ p["wavlm.feature_projection.projection.weight"].T \
        + p["wavlm.feature_projection.projection.bias"]      # [T, D]
    T, D = h.shape
    k = w["num_conv_pos_embeddings"]
    pos = F.conv1d(h.T[None], pos_conv_weight(p), p[f"{POS}.bias"],
                   padding=k // 2, groups=w["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[..., :-1]
    h = layer_norm(h + F.gelu(pos[0]).T, p, "wavlm.encoder.layer_norm", eps)
    H = w["num_attention_heads"]
    dh = D // H
    emb = p["wavlm.encoder.layers.0.attention.rel_attn_embed.weight"]
    bias = emb[buckets(T, w["num_buckets"], w["max_bucket_distance"]).to(
        emb.device)].permute(2, 0, 1)                            # [H, T, T]
    states = [h]
    for i in range(w["num_hidden_layers"]):
        a = f"wavlm.encoder.layers.{i}.attention"

        def lin(z, name):
            return z @ p[f"{a}.{name}.weight"].T + p[f"{a}.{name}.bias"]

        hh = h.view(T, H, dh).transpose(0, 1)                # [H, T, dh]
        g = lin(hh, "gru_rel_pos_linear").view(H, T, 2, 4).sum(-1)
        ga, gb = torch.sigmoid(g)[..., 0], torch.sigmoid(g)[..., 1]
        const = p[f"{a}.gru_rel_pos_const"].view(H, 1)
        gate = ga * (gb * const - 1.0) + 2.0                 # [H, T]
        q, kk, v = (lin(h, n).view(T, H, dh).transpose(0, 1)
                    for n in ("q_proj", "k_proj", "v_proj"))
        s = q @ kk.transpose(1, 2) / math.sqrt(dh) + gate[..., None] * bias
        o = (torch.softmax(s, dim=-1) @ v).transpose(0, 1).reshape(T, D)
        h = layer_norm(h + lin(o, "out_proj"), p,
                       f"wavlm.encoder.layers.{i}.layer_norm", eps)
        f = f"wavlm.encoder.layers.{i}.feed_forward"
        ff = F.gelu(h @ p[f"{f}.intermediate_dense.weight"].T
                    + p[f"{f}.intermediate_dense.bias"])
        ff = ff @ p[f"{f}.output_dense.weight"].T + p[f"{f}.output_dense.bias"]
        h = layer_norm(h + ff, p, f"wavlm.encoder.layers.{i}.final_layer_norm",
                       eps)
        states.append(h)
    lw = torch.softmax(p["layer_weights"], dim=-1)
    h = sum(s * lw[i] for i, s in enumerate(states))
    y = (h @ p["projector.weight"].T + p["projector.bias"]).T[None]
    for i, (kk, dil) in enumerate(zip(w["tdnn_kernel"], w["tdnn_dilation"])):
        wt = p[f"tdnn.{i}.kernel.weight"]
        wt = wt.view(wt.shape[0], kk, -1).transpose(1, 2)
        y = F.relu(F.conv1d(y, wt, p[f"tdnn.{i}.kernel.bias"], dilation=dil))
    stats = torch.cat([y[0].mean(-1), y[0].std(-1)])
    return stats @ p["feature_extractor.weight"].T + p["feature_extractor.bias"]


def conv_frames(n: int, w: Mapping) -> int:
    for k, s in zip(w["conv_kernel"], w["conv_stride"]):
        n = (n - k) // s + 1
    return n


def min_samples(w: Mapping) -> int:
    """The fewest samples that give the TDNN two output frames."""
    context = sum((k - 1) * d for k, d in zip(w["tdnn_kernel"],
                                              w["tdnn_dilation"]))
    n = 1
    while conv_frames(n, w) < context + 2:
        n += 1
    return n


def samples_of(pcm: np.ndarray, lab: Sequence[int], start: int,
               frames: int, w: Mapping, shift: int = 160) -> np.ndarray:
    """The window of `frames` frames from frame `start` of the VAD segment
    `lab` (samples [a, b)) of the dithered 16-bit signal `pcm`: samples
    [a + shift start, min(a + shift (start + frames), b)), clipped to the
    signal, / 32768 as float32, tiled up to min_samples(w)."""
    a, b = int(lab[0]), min(int(lab[1]), len(pcm))
    x = (np.asarray(pcm[a + shift * start:min(a + shift * (start + frames),
                                               b)]) / 32768.0
         ).astype(np.float32)
    need = min_samples(w)
    if len(x) < need:
        x = x[np.arange(need) % len(x)]
    return x


class Plain:
    """The plain model: a state dict under Hugging Face's names (moved to
    `device` as float32) and its widths."""

    def __init__(self, state: Mapping[str, torch.Tensor], w: Mapping,
                 device):
        self.p = {k: torch.as_tensor(v).to(device=device,
                                           dtype=torch.float32)
                  for k, v in state.items()}
        self.w = dict(w)


def embed(model: Plain, windows: Sequence[np.ndarray], device,
          tf32: bool = False) -> np.ndarray:
    """Embeddings [n, xvector_output_dim] of windows [N_i] float32, each
    run alone, in float32 with TF32 `tf32` (False: the reference; True:
    the control)."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.inference_mode():
            return torch.stack([
                forward(model.p, model.w, torch.as_tensor(x, device=device))
                for x in windows]).cpu().numpy()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep
