"""Share of the window in the host init pool (f64 transform, scores,
calibration, linkage, cut and the VB chunks launched under it): the sum of
the runlog `stages` events' `init_s`, in percent of the window."""


def read(ctx):
    vals = [s["init_s"] for s in ctx.get("stages", []) if "init_s" in s]
    if not vals:
        return None
    return 100.0 * sum(vals) / ctx["window_s"]
