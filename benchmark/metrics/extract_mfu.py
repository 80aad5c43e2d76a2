"""The extraction step's share of the card's float32 peak: ResNet101's
operations (yardstick.resnet_flops) of every window the calls completed,
each at its own frame length, over the window times 67 TFLOP/s (float32
with TF32 off, as XVectorExtractor pins it), in percent. The batches'
filler windows are not work and are not counted."""

from benchmark import yardstick


def read(ctx):
    frames = ctx.get("windows")
    if not frames:
        return None
    w = ctx["widths"]
    flops = sum(yardstick.resnet_flops(f, w["feat_dim"],
                                       w["resnet_m_channels"],
                                       w["resnet_blocks"], w["embed_dim"])
                for f in frames)
    return 100.0 * flops / (ctx["window_s"] * yardstick.F32_OPS_PER_S)
