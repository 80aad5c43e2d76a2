"""scripts/torch_profile.py's scan part reads a torch.profiler chrome trace
per annotated call: checked here on a trace written by hand."""

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
