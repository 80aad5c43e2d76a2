"""The port's measurement drivers (scripts/torch_*_bench.py) against the
JAX drivers they stand for (scripts/{ami_scale,linkage_scale,serving,
extractor,scaling}_bench.py), on the CPU at small sizes; and the port's
resnet101(precision=) against vbx_tpu's.

The JAX drivers are loaded from scripts/ by path (serving_bench.py parses
sys.argv when it is imported, so argv is set first). Tolerances: the
AMI-scale labels agree with vbx_tpu's diarize_ark on >= 99.5% of each
meeting's frames (a float32 stop iteration is roundoff); ResNet101
embeddings within tests/test_torch_resnet.py's 2e-4 x max; everything
else is compared exactly.
"""

import ast
import importlib.util
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from vbx_tpu_torch.testing import frame_agreement, host_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
DRIVERS = ("torch_serving_bench", "torch_extractor_bench",
           "torch_ami_scale_bench", "torch_linkage_scale_bench",
           "torch_scaling_bench")
RESNET_BAR = 2e-4          # tests/test_torch_resnet.py
AMI_AGREEMENT = 0.995


def _load(name, argv=None, monkeypatch=None):
    """scripts/<name>.py as a module (with sys.argv = argv while it is
    imported, for a driver that reads it at import)."""
    if argv is not None:
        monkeypatch.setattr(sys, "argv", argv)
    spec = importlib.util.spec_from_file_location(
        f"_driver_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_tail(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_make_corpus_writes_the_jax_drivers_bytes(tmp_path):
    """(a) one meeting of the AMI-scale corpus: ark and segments
    byte-equal to scripts/ami_scale_bench.py's make_corpus."""
    jd, td = tmp_path / "jax", tmp_path / "torch"
    jd.mkdir()
    td.mkdir()
    n_j = _load("ami_scale_bench").make_corpus(str(jd), n_meetings=1)
    n_t, truth = _load("torch_ami_scale_bench").make_corpus(str(td),
                                                            n_meetings=1)
    assert n_t == n_j and 8000 <= n_j < 11000
    assert list(truth) == ["mtg00"] and len(truth["mtg00"]) == n_j
    for f in ("c.ark", "c.seg"):
        assert (jd / f).read_bytes() == (td / f).read_bytes(), f


def test_ami_driver_matches_vbx_tpus_diarize_ark(tmp_path, capsys):
    """(b) the AMI driver on two meetings of T 300-600 on the CPU's
    structured engine (the preset's engine there): its lines, and labels
    that agree with vbx_tpu's
    diarize_ark on the same files on >= 99.5% of every meeting's frames."""
    from vbx_tpu.config import get_preset as jax_preset
    from vbx_tpu.engine.pipeline import diarize_ark as jax_diarize_ark

    drv = _load("torch_ami_scale_bench")
    # the preset's 'pallas_bf16' resolves to the structured engine on the
    # CPU, as in vbx_tpu
    argv = ["--device", "cpu", "--n-meetings", "2", "--frames", "300",
            "600", "--check-meetings", "2"]
    with host_threads(1):
        assert drv.main(argv) == 0
        out = capsys.readouterr().out
        d = str(tmp_path)
        drv.make_corpus(d, n_meetings=2, frames=(300, 600))
        drv.write_models(d)
        mine, _, stages = drv.run(d, drv.preset(), "structured", "cpu")
        ref = jax_diarize_ark(f"{d}/c.ark", f"{d}/c.seg", f"{d}/jrttm",
                              jax_preset("ami_mixheadset"), f"{d}/plda",
                              f"{d}/transform.h5", verbose=False,
                              fb_impl="structured")
    lines = out.splitlines()
    assert lines[0] == "plateau_ulps=4.0"
    assert re.fullmatch(r"corpus: \d+ x-vectors", lines[1])
    assert re.fullmatch(r"2 meetings, \d+ x-vectors \(~[\d.]+ h audio\): "
                        r"[\d.]+s wall -> \d+x realtime", lines[2])
    assert lines[3].startswith("stages: init=")
    assert lines[4].startswith("speakers: [") and \
        lines[5].startswith("iters: [")
    line = _json_tail(out)
    assert line["meetings"] == 2 and line["fb_impl"] == "structured"
    assert min(line["check_vs_cpu"].values()) == 1.0
    assert stages["event"] == "stages" and stages["buckets"]
    assert sorted(mine) == sorted(ref) == ["mtg00", "mtg01"]
    for m in mine:
        assert frame_agreement(ref[m].labels1st, mine[m].labels1st) >= \
            AMI_AGREEMENT, m


def _jax_linkage_labels(xn, ondemand):
    """scripts/linkage_scale_bench.py's steps on vbx_tpu."""
    from vbx_tpu.clustering import (fcluster_by_distance, linkage,
                                    linkage_dot_avg)
    from vbx_tpu.engine import ahc

    cond, thr = ahc._blocked_cosine_condensed_and_thr(
        xn, want_condensed=not ondemand)
    Z = (linkage_dot_avg(xn, backend="native") if ondemand
         else linkage(cond, method="average"))
    adjust = abs(Z[:, 2].min())
    Z[:, 2] += adjust
    return fcluster_by_distance(Z, -(thr + (-0.015)) + adjust)


def _untimed(line):
    return re.sub(r"\d+\.\d+s", "_s", line)


@pytest.mark.parametrize("ondemand", [False, True])
def test_linkage_driver_matches_the_jax_driver(ondemand, capsys,
                                               monkeypatch):
    """(c) N = 400: the port's front half gives the labels of the JAX
    driver's steps on the same x-vectors, and the drivers print the same
    line but for the times."""
    drv = _load("torch_linkage_scale_bench")
    xn = drv.xn_for(np.random.default_rng(0), 400)
    labels, _ = drv.front_half(xn, ondemand)
    np.testing.assert_array_equal(labels, _jax_linkage_labels(xn, ondemand))
    flag = ["--ondemand"] if ondemand else []
    assert drv.main(["400", "--device", "cpu"] + flag) == 0
    mine = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["linkage_scale_bench.py", "400"] + flag)
    _load("linkage_scale_bench").main()
    theirs = capsys.readouterr().out.splitlines()
    assert _untimed(mine[0]) == _untimed(theirs[0])
    row = json.loads(mine[-1])["rows"][0]
    assert row["N"] == 400 and row["clusters"] == len(np.unique(labels))


def test_stage_attribution_prints_the_jax_line(tmp_path, capsys,
                                               monkeypatch):
    """(d) a hand-written service runlog: the port's _stage_attribution
    prints serving_bench.py's line."""
    recs = [{"event": "request", "recording": f"req{i}",
             "wall_ms": 100.0 + 7 * i, "init_done_ms": 10.0 + i,
             "launched_ms": 40.0 + 3 * i} for i in range(20)]
    recs += [{"event": "request", "recording": "__warmup_2_0__",
              "wall_ms": 9e3, "init_done_ms": 1.0, "launched_ms": 2.0},
             {"event": "request", "recording": "req_partial",
              "wall_ms": 50.0, "init_done_ms": None, "launched_ms": 3.0},
             {"event": "batch", "size": 4}]
    path = tmp_path / "serve.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    jax_drv = _load("serving_bench", ["serving_bench.py"], monkeypatch)
    jax_drv._stage_attribution(str(path), "[B] ")
    theirs = capsys.readouterr().out
    got = _load("torch_serving_bench")._stage_attribution(str(path), "[B] ")
    mine = capsys.readouterr().out
    assert mine == theirs and "(20 requests)" in mine
    assert got["init_ms"] == [20.0, 29.0]


def test_serving_driver_runs_on_the_cpu(capsys):
    """(e) 8 requests from 2 threads on the CPU's structured engine: the
    warm-up keeps 5 speakers, every request's labels equal diarize_ark's,
    and the JAX driver's lines come out. (The bucket warm-up is left out
    to keep the test short; the chip smoke runs it.)"""
    drv = _load("torch_serving_bench")
    with host_threads(1):
        rc = drv.main(["8", "2", "structured", "--device", "cpu",
                       "--no-bucket-warmup"])
    cap = capsys.readouterr()
    assert rc == 0, cap.err
    assert "warmup: " in cap.err and ", 5 speakers" in cap.err
    lines = cap.out.splitlines()
    assert re.match(r"served 8 requests in [\d.]+s -> [\d.]+ req/s; "
                    r"latency p50=\d+ms p95=\d+ms p99=\d+ms; mean device "
                    r"batch=[\d.]+ \(batches=\d+, max_batch=\d+\)$",
                    lines[0])
    assert lines[1].startswith("stage attribution (p50/p95 ms): init ")
    line = _json_tail(cap.out)
    assert line["failures"] == [] and line["device"] == "cpu"
    (ph,) = line["phases"]
    assert ph["engine"] == "structured" and ph["labels_differ"] == 0


def test_resnet101_highest_matches_vbx_tpu_and_none_on_the_cpu():
    """(f) the port's resnet101(precision='highest') and vbx_tpu's
    resnet101(precision='highest') with the same weights (the port's seeded
    init, carried over by vbx_tpu's convert_torch_state_dict) give the same
    embeddings (the port's ResNet bar) on a few windows; on the CPU (no
    TF32) precision=None gives the same numbers bit for bit."""
    from vbx_tpu.models import resnet as jr
    from vbx_tpu_torch.models import resnet as tr

    feat = np.random.default_rng(0).standard_normal(
        (3, 64, 40)).astype(np.float32)
    torch.manual_seed(0)
    out = {}
    for prec in ("highest", None):
        tm = tr.resnet101(precision=prec)
        if prec == "highest":
            sd = tm.state_dict()
        tm.load_state_dict(sd)
        with host_threads(1), torch.no_grad():
            out[prec] = tm(torch.from_numpy(feat)).numpy()
    params, stats = jr.convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    fm = jr.resnet101(precision="highest")
    ref = np.asarray(jax.jit(fm.apply)({**params, **stats}, feat))
    np.testing.assert_allclose(out["highest"], ref, rtol=0,
                               atol=RESNET_BAR * np.abs(ref).max())
    np.testing.assert_array_equal(out[None], out["highest"])
    with pytest.raises(ValueError, match="precision"):
        tr.resnet101(precision="high")


def _jax_scaling_keys():
    """The keys of scaling_bench.py's JSON object and of its rows, read
    from its source."""
    tree = ast.parse(open(os.path.join(SCRIPTS, "scaling_bench.py")).read())
    dicts = [n for n in ast.walk(tree) if isinstance(n, ast.Dict)
             and n.keys and all(isinstance(k, ast.Constant) for k in n.keys)]
    keys = [[k.value for k in d.keys] for d in dicts]
    top = next(k for k in keys if "platform" in k)
    row = next(k for k in keys if "axis" in k)
    return top, row


def test_scaling_driver_on_a_cpu_mesh_of_two(capsys, monkeypatch):
    """(g) SCALING_DEVICES=2 CPU copies, T = 64: scaling_bench.py's keys,
    dp and sp rows at 1 and 2 devices, and every mesh's labels equal to
    the solo engine's on the same inputs."""
    drv = _load("torch_scaling_bench")
    monkeypatch.setenv("SCALING_DEVICES", "2")
    with host_threads(1):
        assert drv.main(["--device", "cpu", "--T", "64", "--reps", "1"]) == 0
    line = _json_tail(capsys.readouterr().out)
    top, row = _jax_scaling_keys()
    assert set(top) <= set(line) and set(line) - set(top) == {"device"}
    assert line["platform"] == "cpu" and line["n_devices"] == 2
    assert [(r["axis"], r["devices"]) for r in line["rows"]] == \
        [("dp", 1), ("dp", 2), ("sp", 1), ("sp", 2)]
    for r in line["rows"]:
        assert set(row) <= set(r)
        assert r["agreement_vs_solo"] == 1.0, r


@pytest.mark.parametrize("driver", DRIVERS)
def test_driver_needs_a_card_unless_given_cpu(driver, capsys):
    """(h) with no card and no --device cpu a driver's main() returns
    non-zero, naming --device cpu, before any work and with nothing on
    stdout (its __main__ exits with that code)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    assert _load(driver).main([]) != 0
    cap = capsys.readouterr()
    assert "--device cpu" in cap.err and cap.out == ""
