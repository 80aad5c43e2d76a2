"""scripts/torch_profile.py's scan part reads a torch.profiler chrome trace
per annotated call: checked here on a trace written by hand. Also
vbx_tpu_torch.utils.profiling: trace() off and on, and the device time it
reads back from a trace."""

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
    device work, so its executable time is None, not 0."""
    import torch

    from vbx_tpu_torch.utils import profiling

    monkeypatch.setenv("VBX_TPU_TRACE_DIR", str(tmp_path))
    with profiling.trace() as where:
        with profiling.annotate("work"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert where == str(tmp_path)
    files = list(tmp_path.glob("*.pt.trace.json.gz"))
    assert len(files) == 1
    assert profiling.parse_trace_executable_us(str(tmp_path)) is None
    assert profiling.parse_trace_executable_us(str(tmp_path / "no")) is None


def test_parse_trace_executable_us_sums_device_work_per_device(tmp_path):
    """Kernel, memcpy and memset events summed per device pid, the busiest
    device's total; host events and annotations do not count."""
    from vbx_tpu_torch.utils import profiling

    evs = [dict(_x("kernel", "conv", 10.0, 30.0), pid=0),
           dict(_x("gpu_memcpy", "HtoD", 50.0, 5.5), pid=0),
           dict(_x("kernel", "gemm", 10.0, 20.0), pid=1),
           dict(_x("cpu_op", "aten::conv2d", 0.0, 100.0), pid=7),
           dict(_x("user_annotation", "work", 0.0, 200.0), pid=0)]
    (tmp_path / "h_1.5.pt.trace.json").write_text(
        json.dumps({"traceEvents": evs}))
    assert profiling.parse_trace_executable_us(str(tmp_path)) == \
        pytest.approx(35.5)
