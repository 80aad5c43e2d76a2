"""bench_torch.py, the port's counterpart of bench.py, held to bench.py on
the same files: the bench recording's VB inputs through both packages'
init chains, and its float64 structured VB through both engines; then the
guard, the e2e stage, the JSON line's keys and the no-card exit."""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch
from vbx_tpu.config import get_preset as jax_preset
from vbx_tpu.engine import vbhmm as jvb
from vbx_tpu_torch.config import get_preset
from vbx_tpu_torch.testing import (host_threads, write_bench_recording,
                                   write_corpus)

# bench.py's JSON keys (bench.py main(): the out dict, then headline_impl
# and the trace keys of a run on the accelerator)
BENCH_PY_KEYS = (
    "metric", "value", "unit", "vs_baseline", "value_source",
    "wall_rec_per_sec", "e2e_s_per_recording", "e2e_rec_per_hour",
    "e2e_der", "headline_impl", "trace_ms_per_batch", "trace_rec_per_sec",
    "trace_ms_pallas", "trace_ms_pallas_bf16")


@pytest.fixture(scope="module")
def inputs():
    with host_threads(1):
        return bench_torch.prepare_inputs(get_preset("example"), "cpu")


@pytest.fixture(scope="module")
def f64_run(inputs):
    """bench_device on the CPU at B=4, structured float64, one timed run."""
    fea, phi, qinit, truth = inputs
    with host_threads(1):
        return bench_torch.bench_device(
            fea, phi, qinit, bench_torch.vb_hp(get_preset("example")),
            "structured", truth, B=4, device="cpu", dtype=torch.float64,
            repeats=1)


def test_prepare_inputs_matches_bench_py(inputs, tmp_path, monkeypatch):
    """The same files through bench.py's prepare_inputs (vbx_tpu's
    Diarizer) and the port's: the f64 AHC rule makes the labels, and so
    qinit, equal; fea and phi agree to 1e-10; the shape is bench.py's."""
    files = write_bench_recording(str(tmp_path))
    monkeypatch.setattr(bench, "ARK", files["ark"])
    monkeypatch.setattr(bench, "PLDA", files["plda"])
    monkeypatch.setattr(bench, "H5", files["transform"])
    with host_threads(1):
        fea_j, phi_j, q_j = map(np.asarray,
                                bench.prepare_inputs(jax_preset("example")))
    fea, phi, qinit, (z, main) = inputs
    assert qinit.shape == (1025, 31) and fea.shape == (1025, 128)
    np.testing.assert_array_equal(qinit.argmax(1), q_j.argmax(1))
    np.testing.assert_array_equal(qinit, q_j)
    np.testing.assert_allclose(fea, fea_j, rtol=1e-10,
                               atol=1e-10 * np.abs(fea_j).max())
    np.testing.assert_allclose(phi, phi_j, rtol=1e-10)
    np.testing.assert_array_equal(z, files["truth"]["bench"])
    np.testing.assert_array_equal(main, files["main"])
    assert main.sum() < len(main)


def test_prepare_inputs_raises_on_another_shape(monkeypatch):
    """The shape is the workload's definition: a recording that does not
    give it stops the bench (nothing is padded or cut)."""
    monkeypatch.setattr(bench_torch, "SHAPE_S", 32)
    with host_threads(1), pytest.raises(RuntimeError, match="S=31"):
        bench_torch.prepare_inputs(get_preset("example"), "cpu")


def test_bench_device_f64_matches_jax_structured(inputs, f64_run):
    """bench_device's structured float64 batch against vbx_tpu's
    vbx_batched structured route on the same B=4 copies: the same
    iterations and lane-0 labels, and the guard holds (5 speakers, the
    truth on the main frames, every lane equal)."""
    fea, phi, qinit, _ = inputs
    hp = bench_torch.vb_hp(get_preset("example"))
    B, (T, S) = 4, qinit.shape
    ref = jvb.vbx_batched(
        jnp.asarray(np.broadcast_to(fea, (B, T, fea.shape[1]))),
        jnp.asarray(phi), jnp.asarray(np.broadcast_to(qinit, (B, T, S))),
        jnp.full((B, S), 1.0 / S), jnp.ones((B, T), bool),
        jnp.ones((B, S), bool), loop_prob=hp["loopP"], Fa=hp["Fa"],
        Fb=hp["Fb"], max_iters=hp["max_iters"], epsilon=hp["epsilon"],
        fb_impl="structured")
    assert f64_run["iters"] == int(np.max(np.asarray(ref.n_iters)))
    np.testing.assert_array_equal(f64_run["labels0"],
                                  np.asarray(ref.gamma[0]).argmax(-1))
    g = f64_run["guard"]
    assert g["ok"] and g["speakers"] == 5 and g["agreement"] >= 0.95
    assert g["lanes_differing"] == []
    assert f64_run["k1_launches"] == 0     # the structured route, no kernel


def test_guard_fails_on_a_differing_lane_or_speaker_count(inputs, f64_run):
    """The guard holds on equal lanes of the f64 run and fails on a lane
    that differs or on a fifth speaker merged into another."""
    _, _, _, truth = inputs
    labels = np.stack([f64_run["labels0"]] * 3)
    assert bench_torch.guard(labels, truth)["ok"]
    bad = labels.copy()
    bad[2, 0] = (bad[2, 0] + 1) % 5
    g = bench_torch.guard(bad, truth)
    assert not g["ok"] and g["lanes_differing"] == [2]
    four = np.where(labels == labels[0].max(), labels[0].min(), labels)
    g = bench_torch.guard(four, truth)
    assert not g["ok"] and g["speakers"] == 4 and g["lanes_differing"] == []


def test_bench_trace_gives_none_without_device_work(inputs):
    """A CPU run's trace holds no device work: bench_trace says so and
    returns None, never a number that is not a device time."""
    fea, phi, qinit, _ = inputs
    hp = dict(bench_torch.vb_hp(get_preset("example")), max_iters=1)
    with host_threads(1):
        assert bench_torch.bench_trace(fea, phi, qinit, hp, "structured",
                                       B=1, device="cpu") is None


def test_bench_e2e_on_a_small_corpus(tmp_path):
    corpus = write_corpus(str(tmp_path / "c"), 3, [300, 450, 600, 380],
                          [2, 3, 4, 3])
    with host_threads(1):
        e2e = bench_torch.bench_e2e(get_preset("example"), n_reps=1,
                                    corpus=corpus, device="cpu")
    assert e2e["agreement"] >= 0.95
    assert math.isfinite(e2e["der"]) and 0.0 <= e2e["der"] < 100.0
    assert e2e["s_per_recording"] > 0 and len(e2e["reps"]) == 1
    assert e2e["fb_impl"] == "structured" and e2e["k1_launches"] == 0


def test_result_line_has_bench_py_keys(f64_run):
    e2e = {"s_per_recording": 0.5, "der": 1.0, "agreement": 0.99,
           "fb_impl": "structured", "k1_launches": 0}
    line = bench_torch.result_line(4, 2.0, {"structured": f64_run}, {},
                                   "structured", e2e, "cpu", "cpu")
    for key in BENCH_PY_KEYS:
        assert key in line, key
    assert line["metric"] == "vb_diarization_throughput"
    assert line["value_source"] == "wall"
    assert line["value"] == line["wall_rec_per_sec"] == pytest.approx(
        4 / f64_run["seconds"])
    assert line["vs_baseline"] == pytest.approx(line["value"] * 2.0)
    assert line["e2e_rec_per_hour"] == pytest.approx(7200.0)
    assert line["trace_ms_per_batch"] is None
    assert line["shape"] == [4, 1025, 31, 128]
    assert line["iters"] == f64_run["iters"]
    assert line["backend"] == "cpu" and line["device"] == "cpu"
    assert line["e2e_agreement"] == 0.99
    assert line["e2e_fb_impl"] == "structured"
    assert json.loads(json.dumps(line)) == line


def test_main_without_a_card_exits_non_zero_naming_device_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    assert bench_torch.main([]) != 0
    captured = capsys.readouterr()
    assert "--device cpu" in captured.err
    assert captured.out == ""
