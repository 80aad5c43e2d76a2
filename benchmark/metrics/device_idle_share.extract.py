"""Share of the traced window in which no operation ran on the card: 1
minus the union of the device operations' intervals (kernels, copies,
sets) over the window, in percent."""

from benchmark import yardstick


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    busy = yardstick.union_seconds((s, e) for s, e, _ in tr.window_ops())
    return 100.0 * (1.0 - busy / 1e6 / ctx["window_s"])
