"""The diarization step's share of the card's float32 peak: the
operations of the VB EM's two products (4 B T_pad S_pad D an iteration,
padding included, as the engine runs them) over every chunk of the
runlog `stages` events' `buckets`, each at the iterations it ran, over
the window times 67 TFLOP/s (float32 outside the tensor cores, TF32 off
as the configurations state), in percent."""

from benchmark import yardstick


def read(ctx):
    buckets = [b for s in ctx.get("stages", []) for b in s.get("buckets", [])]
    if not buckets:
        return None
    flops = sum(yardstick.vb_em_flops(b["B"], b["T_pad"], b["S_pad"],
                                      ctx["lda_dim"], b["max_iters_run"])
                for b in buckets)
    return 100.0 * flops / (ctx["window_s"] * yardstick.F32_OPS_PER_S)
