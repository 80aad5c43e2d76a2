"""scripts/torch_profile.py's scan part reads a torch.profiler chrome trace
per annotated call: checked here on a trace written by hand. Also
vbx_tpu_torch.utils.profiling: trace() off and on, and the busy and idle
seconds by span that idle_by_span reads back from a trace."""

import importlib.util
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_profile", os.path.join(ROOT, "scripts", "torch_profile.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


@pytest.mark.parametrize("with_record", [True, False])
def test_trace_per_call_splits_lead_gaps_and_walks(tmp_path, with_record):
    evs = [_x("user_annotation", "call::route_two_pass", 100.0, 500.0),
           _x("kernel", "elementwise", 130.0, 10.0),
           _x("kernel", "void rows::fb_scan_fwd_kernel<4, 4>(...)",
              150.0, 170.0),
           _x("kernel", "void rows::fb_scan_bwd_kernel<4, 4>(...)",
              320.0, 160.0),
           _x("cpu_op", "aten::empty", 105.0, 2.0),
           _x("user_annotation", "call::fb_scan_fwd", 1000.0, 300.0),
           _x("kernel", "void rows::fb_scan_fwd_kernel<4, 4>(...)",
              1040.0, 171.5),
           {"ph": "i", "name": "marker", "ts": 0}]
    if with_record:
        evs += [_x("cuda_runtime", "cudaEventRecord", 104.0, 1.0),
                _x("cuda_runtime", "cudaEventRecord", 590.0, 1.0),
                _x("cuda_runtime", "cudaEventRecord", 1008.0, 1.0)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": evs}))
    rows = _script()._trace_per_call(str(path))
    assert [n for n, _ in rows] == ["route_two_pass", "fb_scan_fwd"]
    two, fwd = rows[0][1], rows[1][1]
    assert two["n_device_ops"] == 3 and fwd["n_device_ops"] == 1
    assert two["lead_us"] == pytest.approx(26.0 if with_record else 30.0)
    assert fwd["lead_us"] == pytest.approx(32.0 if with_record else 40.0)
    # idle from 140 to 150; the backward walk starts as the forward one
    # ends (320)
    assert two["gaps_us"] == pytest.approx(10.0)
    assert two["busy_us"] == pytest.approx(340.0)
    assert two["span_us"] == pytest.approx(350.0)
    assert two["walks_us"] == pytest.approx(
        {"fb_scan_fwd_kernel": 170.0, "fb_scan_bwd_kernel": 160.0})
    assert fwd["walks_us"] == pytest.approx({"fb_scan_fwd_kernel": 171.5})
    assert two["start_from_event_record"] is with_record


def test_trace_per_call_refuses_a_call_without_device_work(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        _x("user_annotation", "call::fb_scan_bwd", 0.0, 50.0)]}))
    with pytest.raises(RuntimeError, match="no device operation"):
        _script()._trace_per_call(str(path))


def test_profiling_trace_is_a_no_op_without_a_directory(monkeypatch):
    from vbx_tpu_torch.utils import profiling

    monkeypatch.delenv("VBX_TPU_TRACE_DIR", raising=False)
    with profiling.trace() as where:
        assert where is None


def test_profiling_trace_writes_a_trace_with_no_device_time_on_the_cpu(
        tmp_path, monkeypatch):
    """VBX_TPU_TRACE_DIR turns the capture on; a CPU-only trace has no
    device work, so its whole window is idle, outside any `vbx.` span."""
    import torch

    from vbx_tpu_torch.utils import profiling

    monkeypatch.setenv("VBX_TPU_TRACE_DIR", str(tmp_path))
    with profiling.trace() as where:
        with profiling.annotate("work"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert where == str(tmp_path)
    files = list(tmp_path.glob("*.pt.trace.json.gz"))
    assert len(files) == 1
    read = profiling.idle_by_span(str(tmp_path))
    assert read["busy_s"] == 0.0 and read["window_s"] > 0
    assert read["idle_s"] == {profiling.OUTSIDE: read["window_s"]}
    assert profiling.idle_by_span(str(tmp_path / "no")) is None


def _root(ts, dur, tid=1):
    return dict(_x("user_annotation", "profiling.trace", ts, dur), tid=tid)


def _span(name, ts, dur, tid=1):
    return dict(_x("user_annotation", name, ts, dur), tid=tid)


def test_idle_by_span_on_a_trace_written_by_hand(tmp_path, capsys):
    """Busy time is the union of two streams' overlapping work; idle time
    goes to the innermost `vbx.` span open on the trace's own thread (a
    nested span takes its part of the outer one's idle time), the rest to
    "outside any span"; other threads' spans, host ops and device work
    outside the window do not count."""
    from vbx_tpu_torch.utils import profiling

    evs = [_root(0.0, 1000.0),
           _span("vbx.pre", 100.0, 400.0),
           _span("vbx.ahc.walk", 200.0, 100.0),
           _span("vbx.vb.chunk", 600.0, 200.0),
           _span("vbx.worker", 0.0, 1000.0, tid=2),   # a pool thread
           _span("other", 850.0, 100.0),
           dict(_x("cpu_op", "aten::copy_", 0.0, 1000.0), tid=1),
           dict(_x("kernel", "k1", 150.0, 100.0), pid=0, tid=7),
           dict(_x("kernel", "k2", 200.0, 80.0), pid=0, tid=8),
           dict(_x("gpu_memcpy", "HtoD", 650.0, 50.0), pid=0, tid=7),
           dict(_x("kernel", "late", 990.0, 100.0), pid=0, tid=7)]
    (tmp_path / "h_1.2.pt.trace.json").write_text(
        json.dumps({"traceEvents": evs}))
    read = profiling.idle_by_span(str(tmp_path))
    # busy: [150, 250) u [200, 280) = 130, the copy 50, [990, 1000) 10
    assert read["busy_s"] == pytest.approx(190e-6)
    assert read["window_s"] == pytest.approx(1000e-6)
    assert read["idle_s"] == pytest.approx({
        "vbx.pre": (100 + 200 - 50) * 1e-6,        # 100-200 (less 150-200)
        "vbx.ahc.walk": 20e-6,                     # 280-300
        "vbx.vb.chunk": 150e-6,
        profiling.OUTSIDE: (100 + 100 + 190) * 1e-6})
    assert sum(read["idle_s"].values()) + read["busy_s"] == \
        pytest.approx(read["window_s"])
    assert list(read["idle_s"])[0] == profiling.OUTSIDE   # largest first
    assert profiling.main([str(tmp_path)]) == 0
    assert json.loads(capsys.readouterr().out) == read
    assert profiling.main([str(tmp_path / "none")]) == 1
