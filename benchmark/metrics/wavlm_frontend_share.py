"""Share of the window in the WavLM conv encoder and feature projection
over a file's batches: the union of the program's `vbx.wavlm.frontend`
spans, each ended by a device synchronize so that its host time is the
stage's card time, clipped to the window, over the window, in percent.
Left out where no such span is in the window."""

from benchmark import yardstick

SPANS = ("vbx.wavlm.frontend",)


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.t0_us is None:
        return None
    iv = [(max(s, tr.t0_us), min(e, tr.t1_us)) for s, e, n in tr.host_ops
          if n in SPANS and e > tr.t0_us and s < tr.t1_us]
    if not iv:
        return None
    return 100.0 * yardstick.union_seconds(iv) / (tr.t1_us - tr.t0_us)
