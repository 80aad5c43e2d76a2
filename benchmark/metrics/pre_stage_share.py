"""Share of the window in the corpus pre-stage (the batched device AHC of
recordings at N >= 6144): the sum of the runlog `stages` events'
`pre_linkage_s` over the window's passes, in percent of the window."""


def read(ctx):
    vals = [s["pre_linkage_s"] for s in ctx.get("stages", [])
            if "pre_linkage_s" in s]
    if not vals:
        return None
    return 100.0 * sum(vals) / ctx["window_s"]
