"""Share of the window in the VB engine's work left after the init pool
finished: the sum of the runlog `stages` events' `vb_s`, in percent of
the window."""


def read(ctx):
    vals = [s["vb_s"] for s in ctx.get("stages", []) if "vb_s" in s]
    if not vals:
        return None
    return 100.0 * sum(vals) / ctx["window_s"]
