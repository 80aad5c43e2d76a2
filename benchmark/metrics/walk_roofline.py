"""The NN-chain walk kernel's share of its roofline: the bytes the window's
walks read (each step the sum rows and sizes of its live clusters, and the
lane's n active flags: Σ rows x (D + 1) x 8 + Σ steps x n x 4 over the
runlog `stages` events' `walk` counts, scripts/kernel_bounds.py's
walk_bound_ms) at the card's HBM rate, over the device time of the
window's `nn_chain` kernels, in percent. Left out where there is no walk
record, where the launches the records count differ from the kernels
traced, or no walk time was traced."""

from benchmark import yardstick


def read(ctx):
    tr = ctx.get("trace")
    walks = [s["walk"] for s in ctx.get("stages", []) if "walk" in s]
    if tr is None or not walks:
        return None
    kernels = [(s, e) for s, e, n in tr.window_ops() if "nn_chain" in n]
    if sum(w["launches"] for w in walks) != len(kernels):
        return None
    walk_s = sum(e - s for s, e in kernels) / 1e6
    if walk_s <= 0:
        return None
    nbytes = sum(w["rows"] * (w["D"] + 1) * 8 + w["step_n"] * 4
                 for w in walks)
    return 100.0 * nbytes / yardstick.HBM_BYTES_PER_S / walk_s
