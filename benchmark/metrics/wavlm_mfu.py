"""WavLM Base Plus SV's share of the card's float32 peak in an extraction
cell: the model's operations (`wavlm_flops`) of every window the calls
completed, over the window times 67 TFLOP/s (float32 with TF32 off, as
XVectorExtractor pins it), in percent. A window of L frames counts L x 160
samples: exact for a full window (144 frames, 23,040 samples), at most one
WavLM frame over for a tail, whose samples end at its VAD segment's end.
The batches' filler windows and the tiling of a window shorter than the
model's minimum are not work and are not counted."""

from benchmark import yardstick

SAMPLES_PER_FRAME = 160


def _conv_len(n, k, s=1, d=1):
    return (n - d * (k - 1) - 1) // s + 1


def wavlm_flops(samples: int, w: dict) -> int:
    """2 x the multiply-adds of the convolutions, linear layers, the
    positional conv and the attention products of one window of `samples`
    samples at widths `w` (WavLMConfig's names); elementwise operations
    and norms are left out."""
    macs, n, cin = 0, samples, 1
    for c, k, s in zip(w["conv_dim"], w["conv_kernel"], w["conv_stride"]):
        n = _conv_len(n, k, s)
        macs += n * c * cin * k
        cin = c
    d, h = w["hidden_size"], w["num_attention_heads"]
    macs += n * cin * d                                  # feature projection
    macs += n * d * (d // w["num_conv_pos_embedding_groups"]) * \
        w["num_conv_pos_embeddings"]                     # positional conv
    layer = (4 * n * d * d                               # q, k, v, out
             + 2 * n * d * w["intermediate_size"]        # FFN
             + 2 * h * n * n * (d // h)                  # scores, values
             + n * h * (d // h) * 8)                     # gate
    macs += w["num_hidden_layers"] * layer
    t, cin = n, d
    macs += t * d * w["tdnn_dim"][0]                     # projector
    cin = w["tdnn_dim"][0]
    for c, k, dil in zip(w["tdnn_dim"], w["tdnn_kernel"],
                         w["tdnn_dilation"]):
        t = _conv_len(t, k, 1, dil)
        macs += t * c * cin * k
        cin = c
    macs += 2 * cin * w["xvector_output_dim"]            # embedding layer
    return 2 * macs


def read(ctx):
    frames = ctx.get("windows")
    if not frames:
        return None
    w = ctx["widths"]
    flops = sum(wavlm_flops(f * SAMPLES_PER_FRAME, w) for f in frames)
    return 100.0 * flops / (ctx["window_s"] * yardstick.F32_OPS_PER_S)
