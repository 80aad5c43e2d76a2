"""Kernel K1's share of its roofline: the least time of every launch
(yardstick.k1_bound at the chunk's bucket shape and the stream type's
element size, one launch an EM iteration of each chunk) over K1's device
time in the trace, in percent. Left out where the launches the buckets
predict differ from the kernel's own launch counter, or no K1 time was
traced."""

from benchmark import yardstick


def read(ctx):
    tr = ctx.get("trace")
    buckets = [b for s in ctx.get("stages", []) for b in s.get("buckets", [])]
    if tr is None or not buckets:
        return None
    predicted = sum(b["max_iters_run"] for b in buckets)
    if predicted != ctx.get("k1_launches"):
        return None
    k1_s = sum(e - s for s, e, n in tr.window_ops() if "fb_fused" in n) / 1e6
    if k1_s <= 0:
        return None
    bound_s = sum(b["max_iters_run"] * yardstick.k1_bound(
        b["B"], b["T_pad"], b["S_pad"], ctx["k1_esize"])["bound_ms"] / 1e3
        for b in buckets)
    return 100.0 * bound_s / k1_s
