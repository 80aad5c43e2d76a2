"""The readers of the program's spans and walk counters (entry_share,
vb_share, extract_host_share, walk_roofline) on hand-made traces and
stage logs: a union of spans, not a sum, clipped to the window; nothing
read where the spans or the walk records are absent; the walk's bytes
against scripts/kernel_bounds.py:walk_bound_ms."""

import importlib.util
import os

import pytest

import bench_tiny
from benchmark import harness, yardstick


class FakeTrace:
    """A stand-in for harness.Traced: host spans, device ops and the
    `bench::window` span's ends (microseconds)."""

    def __init__(self, host_ops=(), device_ops=(), t0=0.0, t1=10e6):
        self.host_ops = list(host_ops)
        self.device_ops = list(device_ops)
        self.t0_us, self.t1_us = t0, t1

    window_ops = harness.Traced.window_ops


SPAN_METRICS = {
    "entry_share": ("vbx.entry.read", "vbx.entry.write"),
    "vb_share": ("vbx.vb.chunk", "vbx.vb.chunk"),
    "extract_host_share": ("vbx.extract.load_wait", "vbx.extract.write"),
}


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_share_is_the_window_clipped_union(metric):
    a, b = SPAN_METRICS[metric]
    tr = FakeTrace(host_ops=[
        (-1e6, 1e6, a),               # 1 s inside the window
        (2e6, 4e6, a), (3e6, 5e6, b),  # overlapping: 3 s, not 4
        (6e6, 6.5e6, "vbx.init"),      # another span
        (6e6, 7e6, "aten::copy_"),     # a host op
        (9.5e6, 12e6, b),              # 0.5 s inside the window
        (11e6, 13e6, a),               # after the window
        (0.0, 10e6, "bench::window")], t0=0.0, t1=10e6)
    read = harness.reader(metric)
    assert read({"trace": tr, "window_s": 10.2}) == pytest.approx(45.0)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_share_is_left_out_without_its_spans(metric):
    read = harness.reader(metric)
    other = FakeTrace(host_ops=[(0.0, 5e6, "vbx.init"),
                                (1e6, 2e6, "aten::copy_")])
    assert read({"trace": other, "window_s": 10.0}) is None
    outside = FakeTrace(host_ops=[(11e6, 12e6, SPAN_METRICS[metric][0])])
    assert read({"trace": outside, "window_s": 10.0}) is None
    assert read({"trace": None, "window_s": 10.0}) is None
    assert read({"window_s": 10.0}) is None


def _walk_bound_ms():
    path = os.path.join(bench_tiny.REPO, "scripts", "kernel_bounds.py")
    spec = importlib.util.spec_from_file_location("kernel_bounds", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.walk_bound_ms


# two passes' walk records: one launch over 2 lanes, one over 1
WALKS = [{"launches": 1, "lanes": 2, "D": 128, "steps": 48_000,
          "rows": 240_000_000, "step_n": 48_000 * 9_000},
         {"launches": 1, "lanes": 1, "D": 128, "steps": 30_000,
          "rows": 150_000_000, "step_n": 30_000 * 10_000}]


def _walk_ctx(kernels, walks=WALKS):
    tr = FakeTrace(device_ops=[
        *kernels, (0.0, 1e5, "void at::native::reduce_kernel<512>")],
        t0=0.0, t1=30e6)
    return {"trace": tr, "window_s": 30.0,
            "stages": [{"init_s": 1.0, "walk": w} for w in walks]}


KERNELS = [(1e6, 1.2e6, "(anonymous namespace)::nn_chain_kernel(Walk)"),
           (11e6, 11.15e6, "(anonymous namespace)::nn_chain_kernel(Walk)")]


def test_walk_roofline_is_the_walks_bytes_over_their_kernel_time():
    bound = _walk_bound_ms()
    # a lane's steps x n as one count: walk_bound_ms at n = 1 reads it
    bound_ms = sum(bound(1, w["rows"], 0, w["D"])
                   + bound(w["step_n"], 0, 1, w["D"]) for w in WALKS)
    got = harness.reader("walk_roofline")(_walk_ctx(KERNELS))
    assert got == pytest.approx(100.0 * bound_ms / 1e3 / 0.35)
    nbytes = sum(w["rows"] * 129 * 8 + w["step_n"] * 4 for w in WALKS)
    assert got == pytest.approx(
        100.0 * nbytes / yardstick.HBM_BYTES_PER_S / 0.35)
    # one lane alone: the same arithmetic as walk_bound_ms(steps, rows, n)
    one = [{"launches": 1, "lanes": 1, "D": 128, "steps": 29_881,
            "rows": 149_000_000, "step_n": 29_881 * 10_000}]
    got = harness.reader("walk_roofline")(_walk_ctx(KERNELS[:1], one))
    assert got == pytest.approx(
        100.0 * bound(29_881, 149_000_000, 10_000, 128) / 200.0)


def test_walk_roofline_is_left_out_on_a_launch_mismatch_or_no_record():
    read = harness.reader("walk_roofline")
    assert read(_walk_ctx(KERNELS[:1])) is None          # 2 launches, 1 traced
    assert read(_walk_ctx(KERNELS + KERNELS[:1])) is None
    assert read(_walk_ctx(KERNELS, walks=[])) is None    # no walk record
    ctx = _walk_ctx(KERNELS)
    assert read(dict(ctx, stages=[{"init_s": 1.0}])) is None
    assert read(dict(ctx, trace=None)) is None
    none = [dict(w, launches=0, lanes=0, steps=0, rows=0, step_n=0)
            for w in WALKS]
    assert read(_walk_ctx([], walks=none)) is None       # no walk time
