"""WavLM Base Plus SV on raw 16 kHz samples (microsoft/wavlm-base-plus-sv,
Hugging Face's `WavLMForXVector`): the program's `WavLMXVector` in its
`XVectorExtractor`, and the plain float32 model of
benchmark/reference/wavlm.py on the same weights and the reference's own
cut of the same samples. The contract is benchmark/extraction_models/
resnet101.py's.

The weights are drawn on `device` from the seed in one call, in the
order and at the shapes of `reference.wavlm.param_shapes` (Hugging Face's
names, the positional conv's weight norm as `original0` / `original1`):
- conv encoder weights N(0, 2 / fan_in) (He, for the GELU after each);
- every other matrix (projections, attention, FFN, gate, TDNN, the
  embedding layer, the positional conv's v) N(0, 1 / fan_in);
- the positional conv's g the norm of its v (so the folded weight is v);
- `rel_attn_embed` and `layer_weights` N(0, 1);
- norm weights and `gru_rel_pos_const` 1 + N(0, 0.1^2), biases N(0, 0.1^2).
The post-LN layers hold the activations at unit scale through the 12
layers, and two different windows give embeddings some 10% apart
(benchmark/tests/test_bench_wavlm.py).
"""

import numpy as np

from benchmark.reference import wavlm as ref


def widths(cell) -> dict:
    return {k: cell.config["widths"][k] for k in ref.PUBLISHED}


def draw_state(seed: int, w: dict, device: str) -> dict:
    """The state dict of the module docstring, float32 on `device`."""
    import torch

    shapes = ref.param_shapes(w)
    total = sum(int(np.prod(s)) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    z = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for k, s in shapes.items():
        n = int(np.prod(s))
        v = z[off:off + n].view(s)
        off += n
        if k.startswith("wavlm.feature_extractor.") and k.endswith(
                "conv.weight"):
            v = v * (2.0 / float(np.prod(s[1:]))) ** 0.5
        elif k.endswith("rel_attn_embed.weight") or k == "layer_weights":
            pass
        elif (k.endswith("weight") or k.endswith("original1")) and len(s) > 1:
            v = v / float(np.prod(s[1:])) ** 0.5
        elif k.endswith("weight") or k.endswith("gru_rel_pos_const"):
            v = 1.0 + 0.1 * v
        elif k.endswith("bias"):
            v = 0.1 * v
        out[k] = v.contiguous()
    g, v = ref.G_V[0]
    out[g] = torch.sqrt((out[v] * out[v]).sum(dim=(0, 1), keepdim=True))
    return out


def build(cell, device):
    from vbx_tpu_torch.config import ExtractorConfig, config_from_dict
    from vbx_tpu_torch.engine.extractor import XVectorExtractor
    from vbx_tpu_torch.models.wavlm import (WavLMWidths, WavLMXVector,
                                            convert_wavlm_state_dict)

    w = widths(cell)
    state = draw_state(cell.seed, w, device)
    model = WavLMXVector(WavLMWidths.from_dict(w))
    model.load_state_dict(convert_wavlm_state_dict(state, model))
    ext = XVectorExtractor(
        model, config_from_dict(cell.config["diarization"]).sample_rate,
        ExtractorConfig(**cell.config["diarization"]["extractor"]),
        batch_size=cell.traffic["batch_size"], device=device)
    return ext, state


def reference(cell, state, device, tf32=False):
    w = widths(cell)
    model = ref.Plain(state, w, device)

    def embed(items):
        return ref.embed(model, [ref.samples_of(pcm, lab, start, n, w)
                                 for pcm, lab, start, n in items],
                         device, tf32=tf32)

    return embed
