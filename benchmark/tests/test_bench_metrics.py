"""The benchmark's arithmetic and per-layer readers on hand-made traces
and stage logs."""

import pytest

import bench_tiny  # noqa: F401
from benchmark import harness, yardstick


class FakeTrace:
    def __init__(self, device_ops, host_ops=(), t0=0.0, t1=None):
        self.device_ops = list(device_ops)
        self.host_ops = list(host_ops)
        self.t0_us = t0
        self.t1_us = t1 if t1 is not None else max(
            e for _, e, _ in self.device_ops)

    window_ops = harness.Traced.window_ops


def test_union_counts_overlaps_once():
    assert yardstick.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) \
        == 4
    assert yardstick.union_seconds([]) == 0.0


def test_idle_gaps():
    assert yardstick.idle_gaps([(1, 2), (4, 5), (1.5, 1.8)], 0, 10) == \
        [(0, 1), (2, 4), (5, 10)]
    assert yardstick.idle_gaps([(0, 10)], 0, 10) == []


def test_k1_bound_at_the_ami_bucket():
    b = yardstick.k1_bound(18, 16384, 32, 2)
    assert b["bytes"] == 3 * 18 * 16384 * 32 * 2 + 18 * 16384 * 4 \
        + 3 * 18 * 32 * 4
    assert b["bound_ms"] == pytest.approx(0.017257, rel=1e-4)
    assert b["bound_by"] == "bytes"


def test_resnet101_window_operations():
    # 1.446 TFLOP a [128, 64, 144] batch (PERF.md), counted by layer hooks
    assert yardstick.resnet_flops(144) == 11_300_569_088
    assert yardstick.resnet_flops(40) == 3_145_105_408


STAGES = [
    {"pre_linkage_s": 2.0, "init_s": 1.0, "vb_s": 0.5,
     "buckets": [{"B": 2, "T_pad": 1024, "S_pad": 8, "max_iters_run": 40},
                 {"B": 1, "T_pad": 2048, "S_pad": 16,
                  "max_iters_run": 10}]},
    {"pre_linkage_s": 3.0, "init_s": 2.0, "vb_s": 0.5,
     "buckets": [{"B": 4, "T_pad": 512, "S_pad": 8, "max_iters_run": 40}]},
]


def test_stage_shares():
    ctx = {"stages": STAGES, "window_s": 10.0}
    assert harness.reader("pre_stage_share")(ctx) == pytest.approx(50.0)
    assert harness.reader("init_share")(ctx) == pytest.approx(30.0)
    assert harness.reader("vb_tail_share")(ctx) == pytest.approx(10.0)
    empty = {"stages": [{}], "window_s": 10.0}
    for m in ("pre_stage_share", "init_share", "vb_tail_share", "vb_mfu",
              "k1_roofline"):
        assert harness.reader(m)(empty) is None


def test_vb_mfu():
    ctx = {"stages": STAGES, "window_s": 2.0, "lda_dim": 128}
    flops = 4 * 128 * (2 * 1024 * 8 * 40 + 2048 * 16 * 10 + 4 * 512 * 8 * 40)
    assert harness.reader("vb_mfu")(ctx) == pytest.approx(
        100 * flops / (2.0 * 67e12))


def test_k1_roofline_checks_the_launch_count():
    tr = FakeTrace([(0.0, 1000.0, "void fb_fused_narrow_kernel<bf16>"),
                    (1000.0, 1500.0, "ampere_sgemm"),
                    (2000.0, 3000.0, "void fb_fused_wide_kernel<bf16>")])
    ctx = {"stages": STAGES, "trace": tr, "k1_launches": 90,
           "k1_esize": 2}
    bound_ms = (40 * yardstick.k1_bound(2, 1024, 8, 2)["bound_ms"]
                + 10 * yardstick.k1_bound(1, 2048, 16, 2)["bound_ms"]
                + 40 * yardstick.k1_bound(4, 512, 8, 2)["bound_ms"])
    assert harness.reader("k1_roofline")(ctx) == pytest.approx(
        100 * bound_ms / 2.0)
    assert harness.reader("k1_roofline")(dict(ctx, k1_launches=91)) is None
    assert harness.reader("k1_roofline")(dict(ctx, trace=None)) is None


@pytest.mark.parametrize("metric", ["device_idle_share.diarize",
                                    "device_idle_share.extract"])
def test_idle_share_is_one_minus_the_busy_union(metric):
    tr = FakeTrace([(0, 2e6, "a"), (1e6, 3e6, "b"), (6e6, 7e6, "c")],
                   t0=0.0, t1=10e6)
    assert harness.reader(metric)({"trace": tr, "window_s": 10.0}) == \
        pytest.approx(60.0)
    assert harness.reader(metric)({"trace": None, "window_s": 1}) is None


def test_extract_mfu_counts_each_window_at_its_length():
    w = {"feat_dim": 64, "resnet_m_channels": 32,
         "resnet_blocks": [3, 4, 23, 3], "embed_dim": 256}
    ctx = {"windows": [144, 144, 40], "window_s": 1.0, "widths": w}
    assert harness.reader("extract_mfu")(ctx) == pytest.approx(
        100 * (2 * 11_300_569_088 + 3_145_105_408) / 67e12)
    assert harness.reader("extract_mfu")(dict(ctx, windows=[])) is None


def test_window_ops_are_clipped_to_the_window():
    tr = FakeTrace([(0, 10, "a"), (5, 30, "b"), (40, 50, "c")], t0=8,
                   t1=35)
    assert tr.window_ops() == [(8, 10, "a"), (8, 30, "b")]


def test_breakdown_names_devices_ops_and_gaps():
    tr = FakeTrace([(0, 4e6, "gemm"), (5e6, 6e6, "k1"), (8e6, 9e6, "k1")],
                   host_ops=[(4e6, 4.9e6, "aten::copy_"),
                             (0, 10e6, "bench::window")], t0=0, t1=10e6)
    b = harness.breakdown(tr)
    assert b["device_ops"] == [["gemm", 4.0], ["k1", 2.0]]
    assert b["idle_gaps"][0] == ["host: no torch op", 2.0]
    assert ["aten::copy_", 1.0] in b["idle_gaps"]
    assert len(b["idle_gaps"]) == 3
