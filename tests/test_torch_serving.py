"""The port's serving daemon (vbx_tpu_torch.serving and cli/serve.py) on the
CPU: vbx_tpu's tests/test_serving.py scenarios on synthetic corpora written
by vbx_tpu_torch.testing (no reference assets), and the same requests
through vbx_tpu's service and the port's.

Bars: the service's labels and RTTMs equal the offline pipeline's byte for
byte (the structured engine's result does not depend on its batch, at
tests/test_torch_pipeline.py's byte-equal bar); the port's service and
vbx_tpu's (XLA:CPU) give byte-equal RTTMs, the bar
tests/test_torch_pipeline.py holds diarize_ark to."""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vbx_tpu_torch.cli.serve import make_handler
from vbx_tpu_torch.config import get_preset
from vbx_tpu_torch import serving as tserving
from vbx_tpu_torch.engine import pipeline as tpipe
from vbx_tpu_torch.io.ark import read_vec_ark_grouped
from vbx_tpu_torch.io.segments import read_xvector_timing_dict
from vbx_tpu_torch.serving import (DiarizationService, ServeResult,
                                   ServiceOverloaded, _Request)
from vbx_tpu_torch.testing import host_threads, write_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENGTHS = [180, 420, 260, 330]
SPEAKERS = [2, 4, 3, 3]


# several test workers share the host: keep this file's pools to one thread
@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    with host_threads(1):
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    c = write_corpus(str(tmp_path_factory.mktemp("serve")), 5, LENGTHS,
                     SPEAKERS)
    segs = read_xvector_timing_dict(c["segments"])
    c["recs"] = {rec: (x, segs[rec][1]) for rec, _, x in
                 read_vec_ark_grouped(c["ark"])}
    return c


@pytest.fixture(scope="module")
def offline(corpus, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("offline"))
    out = tpipe.diarize_ark(corpus["ark"], corpus["segments"], out_dir,
                            get_preset("example"), corpus["plda"],
                            corpus["transform"], verbose=False, device="cpu")
    return out, out_dir


def _service(corpus, cfg=None, **kw):
    kw.setdefault("device", "cpu")
    return DiarizationService.from_files(
        cfg or get_preset("example"), corpus["plda"], corpus["transform"],
        **kw)


def _rttm(out_dir, rec):
    with open(os.path.join(out_dir, f"{rec}.rttm")) as fp:
        return fp.read()


def test_service_matches_offline_pipeline(corpus, offline, tmp_path):
    """Concurrently submitted requests ride one micro-batch and give the
    offline pipeline's RTTMs; one runlog record per request."""
    off, off_dir = offline
    runlog = str(tmp_path / "serve.jsonl")
    with _service(corpus, batch_window_ms=300.0, runlog_path=runlog) as svc:
        futs = {rec: svc.submit(rec, x, ts)
                for rec, (x, ts) in corpus["recs"].items()}
        results = {rec: f.result(timeout=120) for rec, f in futs.items()}
        stats = svc.stats()
    assert set(results) == set(off)
    for rec, res in results.items():
        assert isinstance(res, ServeResult)
        assert res.n_speakers == off[rec].n_speakers
        np.testing.assert_array_equal(res.labels1st, off[rec].labels1st)
        assert res.rttm == _rttm(off_dir, rec)
        assert res.wall_ms > 0
    assert stats["requests"] == len(off) and stats["failed"] == 0
    assert stats["max_batch"] >= 2
    assert stats["batches"] < len(off) + 1
    assert stats["pending"] == 0
    events = [json.loads(line) for line in open(runlog)]
    assert sorted(e["recording"] for e in events
                  if e["event"] == "request") == sorted(off)


def test_service_matches_vbx_tpus_service(corpus):
    """The same requests through vbx_tpu's service (XLA:CPU) and the
    port's: byte-equal RTTMs and equal labels. (The iteration a float32
    run stops at is roundoff at epsilon = 1e-6: ROADMAP.md section 3,
    closed; it is not compared.)"""
    from vbx_tpu.config import get_preset as jpreset
    from vbx_tpu.serving import DiarizationService as JService

    with _service(corpus, batch_window_ms=200.0) as svc:
        mine = {rec: svc.submit(rec, x, ts)
                for rec, (x, ts) in corpus["recs"].items()}
        mine = {rec: f.result(timeout=120) for rec, f in mine.items()}
    with JService.from_files(jpreset("example"), corpus["plda"],
                             corpus["transform"],
                             batch_window_ms=200.0) as jsvc:
        theirs = {rec: jsvc.submit(rec, x, ts)
                  for rec, (x, ts) in corpus["recs"].items()}
        theirs = {rec: f.result(timeout=300) for rec, f in theirs.items()}
    for rec in corpus["recs"]:
        assert mine[rec].rttm == theirs[rec].rttm, rec
        np.testing.assert_array_equal(mine[rec].labels1st,
                                      theirs[rec].labels1st)


def test_mixed_length_requests_split_into_buckets(corpus, tmp_path):
    """One micro-batch of requests of different lengths splits into the
    corpus pipeline's (T, S) buckets; labels equal the batched pipeline's
    over an ark of the same pseudo-recordings (the same bucket shapes)."""
    from vbx_tpu_torch.io.ark import write_vec_ark
    from vbx_tpu_torch.io.segments import write_segments

    x_all = np.concatenate([x for x, _ in corpus["recs"].values()])
    t_all = np.concatenate([t for _, t in corpus["recs"].values()])
    reqs = {"long": (x_all[:700], t_all[:700]),
            "short": (x_all[700:1025], t_all[700:1025])}
    with _service(corpus, batch_window_ms=300.0) as svc:
        futs = {r: svc.submit(r, x, ts) for r, (x, ts) in reqs.items()}
        results = {r: f.result(timeout=120) for r, f in futs.items()}
        stats = svc.stats()
    assert stats["max_batch"] == 2
    ark2, seg2 = str(tmp_path / "mixed.ark"), str(tmp_path / "mixed.seg")
    vecs, rows = [], []
    for r, (x, ts) in reqs.items():
        for i, (v, (s, e)) in enumerate(zip(x, ts)):
            vecs.append((f"{r}_{i:08d}", v))
            rows.append((f"{r}_{i:08d}", r, float(s), float(e)))
    write_vec_ark(ark2, vecs)
    write_segments(seg2, rows)
    off = tpipe.diarize_ark(ark2, seg2, str(tmp_path / "off2"),
                            get_preset("example"), corpus["plda"],
                            corpus["transform"], verbose=False, device="cpu")
    for r, (x, _) in reqs.items():
        assert len(results[r].labels1st) == len(x)
        np.testing.assert_array_equal(results[r].labels1st,
                                      off[r].labels1st)


def test_service_on_a_cpu_mesh_matches_offline(corpus, offline):
    """A ('dp', 'sp') mesh of CPU copies routes buckets through the sharded
    engine; results equal the offline pipeline's, including when the batch
    pads up to the 'dp' extent (3 requests on dp=2)."""
    from vbx_tpu_torch.parallel import make_mesh

    off, off_dir = offline
    recs = dict(list(corpus["recs"].items())[:3])
    with _service(corpus, mesh=make_mesh(2, 2, device="cpu"),
                  batch_window_ms=300.0) as svc:
        futs = {rec: svc.submit(rec, x, ts) for rec, (x, ts) in recs.items()}
        results = {rec: f.result(timeout=240) for rec, f in futs.items()}
    for rec in recs:
        np.testing.assert_array_equal(results[rec].labels1st,
                                      off[rec].labels1st)
        assert results[rec].rttm == _rttm(off_dir, rec)
    with pytest.raises(ValueError, match="'sp' extent 3"):
        _service(corpus, mesh=make_mesh(1, 3, device="cpu"))


def test_service_output_2nd(corpus, tmp_path):
    """output_2nd returns the second-best labeling, equal to the offline
    pipeline's <dir>2nd RTTMs."""
    cfg = get_preset("example").replace(output_2nd=True)
    off_dir = str(tmp_path / "off")
    tpipe.diarize_ark(corpus["ark"], corpus["segments"], off_dir, cfg,
                      corpus["plda"], corpus["transform"], verbose=False,
                      device="cpu")
    with _service(corpus, cfg, batch_window_ms=200.0) as svc:
        futs = {r: svc.submit(r, x, ts)
                for r, (x, ts) in corpus["recs"].items()}
        results = {r: f.result(timeout=120) for r, f in futs.items()}
    for rec, res in results.items():
        assert res.rttm_2nd is not None and res.labels2nd is not None
        assert res.rttm_2nd == _rttm(off_dir + "2nd", rec)
        assert res.rttm == _rttm(off_dir, rec)


def test_service_failure_isolation(corpus):
    """A request whose init raises fails only its own future; the batch
    mates succeed and the service keeps serving."""
    good, (x_good, ts_good) = sorted(corpus["recs"].items())[0]
    with _service(corpus, batch_window_ms=200.0) as svc:
        f_bad = svc.submit("bad", np.full_like(x_good, np.nan), ts_good)
        f_good = svc.submit(good, x_good, ts_good)
        res = f_good.result(timeout=120)
        with pytest.raises(ValueError, match="non-finite"):
            f_bad.result(timeout=120)
        res2 = svc.diarize(good, x_good, ts_good, timeout=120)
        stats = svc.stats()
    np.testing.assert_array_equal(res.labels1st, res2.labels1st)
    assert stats["failed"] == 1 and stats["requests"] == 3
    assert stats["pending"] == 0


def test_cancelled_future_does_not_poison_batch(corpus):
    items = sorted(corpus["recs"].items())
    with _service(corpus, batch_window_ms=300.0) as svc:
        f_cancel = svc.submit(items[0][0], *items[0][1])
        f_keep = svc.submit(items[1][0], *items[1][1])
        cancelled = f_cancel.cancel()   # races the dispatcher
        assert f_keep.result(timeout=120).n_speakers >= 1
        if cancelled:
            with pytest.raises(Exception):
                f_cancel.result(timeout=1)
        for _ in range(100):
            if svc.stats()["requests"] == 2:
                break
            time.sleep(0.05)
        stats = svc.stats()
    assert stats["requests"] == 2      # cancelled requests stay counted


def test_service_rejects_malformed_submissions(corpus):
    with _service(corpus) as svc:
        with pytest.raises(ValueError):
            svc.submit("x", np.zeros((4,)), np.zeros((4, 2)))
        with pytest.raises(ValueError):
            svc.submit("x", np.zeros((4, 8)), np.zeros((3, 2)))
        with pytest.raises(ValueError, match="empty"):
            svc.submit("x", np.zeros((0, 8)), np.zeros((0, 2)))
        with pytest.raises(RuntimeError, match="no extractor"):
            svc.submit_audio("x", np.zeros(160), np.array([[0.0, 0.01]]))
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit("x", np.zeros((4, 8)), np.zeros((4, 2)))


def test_warmup_rejects_bad_batch_sizes_and_rides_exact_shapes(corpus):
    """Empty or non-positive warmup batch lists fail at validation; a wave
    of k requests rides ONE chunk of size k even with aggressive partial
    launches, with the payload's own bucket."""
    x, ts = corpus["recs"]["rec001"]
    with _service(corpus, partial_after_ms=1.0,
                  batch_window_ms=200.0) as svc:
        with pytest.raises(ValueError, match="batch_sizes"):
            svc.warmup(batch_sizes=())
        with pytest.raises(ValueError, match="batch_sizes"):
            svc.warmup(batch_sizes=(4, 0))
        res = svc.warmup(batch_sizes=(4,), payload=(x, ts))
        stats = svc.stats()
        plain = svc.warmup()          # synthetic payload, batch 1
    assert res.batch_size == 4 and stats["max_batch"] == 4
    assert plain.batch_size == 1 and plain.n_speakers >= 1


def test_request_size_limit(corpus):
    with _service(corpus, max_request_xvectors=100) as svc:
        with pytest.raises(ValueError, match="max_request_xvectors"):
            svc.submit("big", np.zeros((101, 256), np.float32),
                       np.zeros((101, 2)))
        fut = svc.submit("ok", np.random.default_rng(0).normal(
            size=(100, 256)).astype(np.float32),
            np.stack([np.arange(100) * 0.24,
                      np.arange(100) * 0.24 + 1.44], 1))
        assert fut.result(timeout=120).n_speakers >= 1


def test_batch_padding_policy(tmp_path, monkeypatch):
    """utils.bucketing.chunk_cap, the one cap of the corpus pass and the
    service, never admits a chunk whose PADDED batch (a multiple of 'dp',
    engine.pipeline.run_vb_chunk) exceeds the frames budget of every
    device (vbx_tpu's test, on the port's rule). Without a mesh the port
    pads nothing: the batch is B and the cap the frames budget's (vbx_tpu's
    power-of-two buckets bought XLA one program a size). Where t_pad
    exceeds the per-device budget (4096 frames, t_pad 8192, a 2x2 mesh) a
    chunk holds 2 lanes, 4096 frames a device; the corpus pass once took 4.
    Both callers hold their mesh chunks to the cap."""
    from vbx_tpu_torch.parallel import engine as tpeng
    from vbx_tpu_torch.parallel import make_mesh
    from vbx_tpu_torch.utils.bucketing import chunk_cap, round_up

    for n_dp in (1, 2, 3, 4, 5, 7):
        for B in range(1, 33):
            Bp = round_up(B, n_dp)
            assert Bp >= B and Bp % n_dp == 0 and Bp < B + n_dp, \
                (n_dp, B, Bp)
    for t_pad in (256, 512, 1024, 1536, 4096, 8192):
        assert chunk_cap(t_pad, 4096) == max(1, 4096 // t_pad)
    for n_dp in (1, 2, 3):
        meshy = SimpleNamespace(shape={"dp": n_dp, "sp": 2}, size=2 * n_dp)
        for t_pad in (256, 512, 1536):
            raw = (4096 * 2 * n_dp) // t_pad
            cap = chunk_cap(t_pad, 4096, meshy)
            assert cap >= 1 and round_up(cap, n_dp) <= raw \
                and cap > raw - n_dp
    mesh = make_mesh(2, 2, device="cpu")
    assert chunk_cap(8192, 4096, mesh) == 2
    # the callers: six recordings of one 256-frame bucket under a budget of
    # 128 frames a device, 2 lanes a chunk (the corpus pass's doubling
    # once reached 3 live lanes, padded to 4)
    cap = chunk_cap(256, 128, mesh)
    assert cap == 2
    c = write_corpus(str(tmp_path), 3, [200, 220, 240, 256, 250, 210],
                     [3, 2, 3, 2, 3, 2])
    cfg = get_preset("example")
    cfg = cfg.replace(vb=dataclasses.replace(cfg.vb, max_iters=2))
    lanes = []
    real = tpeng.vbx_sharded

    def spy(mesh_, X, *a, **k):
        lanes.append(X.shape[0])
        return real(mesh_, X, *a, **k)

    monkeypatch.setattr(tpeng, "vbx_sharded", spy)
    out = tpipe.diarize_ark(c["ark"], c["segments"], str(tmp_path / "r"),
                            cfg, c["plda"], c["transform"], verbose=False,
                            device="cpu", mesh=mesh, max_batch_frames=128)
    assert len(out) == 6 and sum(lanes) >= 6 and max(lanes) <= cap, lanes
    lanes.clear()
    segs = read_xvector_timing_dict(c["segments"])
    with _service(c, cfg=cfg, mesh=mesh, max_batch_frames=128,
                  batch_window_ms=300.0) as svc:
        futs = [svc.submit(rec, x, segs[rec][1])
                for rec, _, x in read_vec_ark_grouped(c["ark"])]
        assert all(f.result(timeout=240).n_iters >= 1 for f in futs)
    assert sum(lanes) >= 6 and max(lanes) <= cap, lanes


def test_cohort_spanning_many_chunks(corpus, offline):
    """A cohort larger than the frames-budget chunk cap splits into several
    chunks (the bounded in-flight fetch) and still matches offline."""
    off, _ = offline
    with _service(corpus, batch_window_ms=500.0,
                  max_batch_frames=1024) as svc:
        futs = {rec: svc.submit(rec, x, ts)
                for rec, (x, ts) in corpus["recs"].items()}
        results = {rec: f.result(timeout=240) for rec, f in futs.items()}
        assert svc.stats()["failed"] == 0
    assert max(r.batch_size for r in results.values()) <= 2
    for rec in off:
        np.testing.assert_array_equal(results[rec].labels1st,
                                      off[rec].labels1st)


def test_partial_launch_frees_cohort_from_straggler_init(corpus,
                                                         monkeypatch):
    """With partial launches, requests whose init finishes promptly ride an
    early partial chunk and finish before a straggler's init has ended (it
    sleeps 2 s); with partial_after_ms=inf they all wait for it. Each fast
    request's completion is held against the moment the straggler's sleep
    ends, not against a wall-clock bound that host load can cross. The
    RTTMs are the same either way."""
    recs = dict(corpus["recs"])
    slow = "rec000"
    sx, sts = recs[slow]
    recs[slow] = (sx[:len(sx) - 17], sts[:len(sx) - 17])
    real_init = tpipe.Diarizer.initial_labels
    gate = {"armed": False, "slept_until": None}

    def slow_init(self, x, seed=0, **kw):
        if len(x) == len(recs[slow][0]) and gate["armed"]:
            gate["armed"] = False
            time.sleep(2.0)
            gate["slept_until"] = time.perf_counter()
        return real_init(self, x, seed=seed, **kw)

    monkeypatch.setattr(tpipe.Diarizer, "initial_labels", slow_init)
    results, done_at, slept_until = {}, {}, {}
    for partial_ms in (float("inf"), 60.0):
        gate["armed"] = True
        done = done_at[partial_ms] = {}
        with _service(corpus, partial_after_ms=partial_ms,
                      batch_window_ms=400.0) as svc:
            futs = {rec: svc.submit(rec, *recs[rec])
                    for rec in [slow] + [n for n in recs if n != slow]}
            for rec, f in futs.items():
                f.add_done_callback(
                    lambda _, rec=rec: done.setdefault(rec,
                                                       time.perf_counter()))
            results[partial_ms] = {rec: f.result(timeout=300)
                                   for rec, f in futs.items()}
        slept_until[partial_ms] = gate["slept_until"]
    fast = [n for n in recs if n != slow]
    r_wait, r_part = results[float("inf")], results[60.0]
    for rec in recs:
        assert r_wait[rec].rttm == r_part[rec].rttm, rec
    assert all(r_part[rec].batch_size < len(recs) for rec in fast)
    assert all(done_at[60.0][rec] < slept_until[60.0] for rec in fast)
    assert all(done_at[float("inf")][rec] > slept_until[float("inf")]
               for rec in fast)


def test_dispatcher_failure_fails_all_futures(corpus, monkeypatch):
    svc = _service(corpus, batch_window_ms=100.0)
    try:
        monkeypatch.setattr(
            tserving, "run_vb_chunk",
            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
        rng = np.random.default_rng(0)
        x = rng.normal(size=(64, 256)).astype(np.float32)
        ts = np.stack([np.arange(64) * 0.24,
                       np.arange(64) * 0.24 + 1.44], axis=1)
        futs = [svc.submit(f"r{i}", x, ts) for i in range(4)]
        for f in futs:
            with pytest.raises(RuntimeError, match="boom"):
                f.result(timeout=120)
    finally:
        svc.close()


def test_dispatcher_soak_mixed_sizes_and_jitter(corpus):
    """Staggered submissions of mixed-length requests from 4 threads with
    tight partial-launch deadlines: every future completes and equals the
    single-request result for its payload."""
    x_full = np.concatenate([x for x, _ in corpus["recs"].values()])
    rng = np.random.default_rng(0)
    lengths = [40, 64, 170, 170, 256, 40, 300, 64, 170, 256, 40, 300]
    payloads = {}
    for i, L in enumerate(lengths):
        off = int(rng.integers(0, len(x_full) - L))
        ts = np.stack([np.arange(L) * 0.24, np.arange(L) * 0.24 + 1.44],
                      axis=1)
        payloads[f"req{i:02d}"] = (x_full[off:off + L], ts)
    with _service(corpus, batch_window_ms=5.0, partial_after_ms=10.0) as svc:
        expected = {rec: svc.diarize(rec, x, ts, timeout=300).labels1st
                    for rec, (x, ts) in payloads.items()}
        futs, lock = {}, threading.Lock()
        delays = rng.integers(0, 30, size=len(payloads)) / 1000.0

        def client(names):
            for rec in names:
                time.sleep(delays[int(rec[3:])])
                f = svc.submit(rec + "_c", *payloads[rec])
                with lock:
                    futs[rec] = f

        names = list(payloads)
        threads = [threading.Thread(target=client, args=(names[k::4],))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for rec, f in futs.items():
            np.testing.assert_array_equal(f.result(timeout=300).labels1st,
                                          expected[rec], err_msg=rec)
        assert svc.stats()["failed"] == 0


def test_admission_bound_sheds_load_and_recovers(corpus):
    """max_pending_requests: at the cap submit() raises ServiceOverloaded;
    releasing slots re-opens admission; under sustained overload clients
    that retry all complete and the pending gauge returns to zero."""
    from concurrent.futures import ThreadPoolExecutor

    x_raw, ts = corpus["recs"]["rec000"]
    with _service(corpus, max_pending_requests=2) as svc:
        probe_a, probe_b = (_Request(n, x_raw, ts) for n in "ab")
        with svc._lock:
            svc._admit(probe_a)
            svc._admit(probe_b)
        with pytest.raises(ServiceOverloaded, match="max_pending_requests"):
            svc.submit("rec000", x_raw, ts)
        assert svc.stats()["pending"] == 2
        svc._release(probe_a)
        svc._release(probe_b)
        assert svc.submit("rec000", x_raw, ts).result(
            timeout=300).n_speakers >= 1
        assert svc.stats()["pending"] == 0
    with _service(corpus, max_pending_requests=3,
                  batch_window_ms=10.0) as svc:
        def one(i):
            for _ in range(600):
                try:
                    fut = svc.submit(f"soak{i}", x_raw, ts)
                    break
                except ServiceOverloaded:
                    time.sleep(0.02)
            else:
                raise AssertionError("never admitted")
            return fut.result(timeout=300).n_speakers

        with ThreadPoolExecutor(max_workers=6) as pool:
            assert all(s >= 1 for s in pool.map(one, range(12)))
        assert svc.stats()["pending"] == 0
        assert svc.stats()["failed"] == 0


def test_serving_default_engine_overrides_corpus_bf16(corpus, monkeypatch):
    """A daemon on a corpus preset does not default to its bf16
    run-to-max engine: fb_impl=None resolves to 'pallas' on a card, with
    vbx_tpu's warning; an explicit fb_impl wins. The card is simulated by
    the engine resolution vbx_tpu's test patches (its backend)."""
    import vbx_tpu_torch.serving as serving

    monkeypatch.setattr(serving, "resolve_fb_impl",
                        lambda fb, cfg, dev: fb or cfg.vb.fb_impl)
    cfg = get_preset("ami_mixheadset")
    assert cfg.vb.fb_impl == "pallas_bf16"
    with pytest.warns(UserWarning, match="overriding the config's "
                      "fb_impl='pallas_bf16'"):
        svc = _service(corpus, cfg)
    with svc:
        assert svc._fb_impl == "pallas"
    with _service(corpus, cfg, fb_impl="pallas_bf16") as svc:
        assert svc._fb_impl == "pallas_bf16"


# -- audio requests ----------------------------------------------------------


def _tiny_extractor_and_models(seed=5):
    """A narrow random ResNet x-vector model (32-d) on the CPU, with a
    matching synthetic 32 -> 16 transform and 16-d PLDA, so the audio path
    runs without reference weights (vbx_tpu's test's recipe)."""
    from vbx_tpu_torch.engine.extractor import XVectorExtractor
    from vbx_tpu_torch.models.resnet import BasicBlock, ResNetXVector

    torch.manual_seed(0)
    model = ResNetXVector(BasicBlock, (1, 1, 1, 1), 16, 64, 32)
    ex = XVectorExtractor(model, 16000, batch_size=8, device="cpu")
    rng = np.random.default_rng(seed)
    transform = (rng.normal(size=32) * 0.01, rng.normal(size=(32, 16)),
                 rng.normal(size=16) * 0.01)
    plda = (rng.normal(size=16) * 0.01,
            rng.normal(size=(16, 16)) + 4 * np.eye(16),
            np.linspace(2.0, 0.2, 16))
    cfg = get_preset("example").replace(lda_dim=16)
    return ex, cfg, plda, transform


def test_audio_request_matches_extract_then_diarize():
    ex, cfg, plda, transform = _tiny_extractor_and_models()
    rng = np.random.default_rng(11)
    signal = rng.uniform(-0.5, 0.5, 8 * 16000)
    vad = np.array([[0.2, 4.0], [4.5, 7.8]])
    with DiarizationService(cfg, plda, transform, extractor=ex,
                            device="cpu") as svc:
        res_audio = svc.diarize_audio("recA", signal, vad, timeout=300)
        segs = ex.extract_file(signal, vad, "recA")
        x = np.stack([s.xvector for s in segs])
        ts = np.array([[s.start, s.end] for s in segs])
        res_xv = svc.diarize("recA", x, ts, timeout=300)
        with pytest.raises(ValueError, match="vad"):
            svc.submit_audio("x", signal, np.zeros((2, 3)))
    assert len(res_audio.labels1st) == len(segs) > 5
    np.testing.assert_array_equal(res_audio.labels1st, res_xv.labels1st)
    assert res_audio.rttm == res_xv.rttm
    assert res_audio.rttm.startswith("SPEAKER recA 1 ")


def _start(svc):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(base, payload, path="/diarize"):
    req = urllib.request.Request(
        f"{base}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=120) as r:
        return r.status, json.loads(r.read())


def test_http_wav_request(tmp_path):
    """POST /diarize with a server-local wav + lab (or inline VAD); a wrong
    sample rate and a server without an extractor answer 400."""
    from vbx_tpu_torch.io.wav import write_wav

    ex, cfg, plda, transform = _tiny_extractor_and_models()
    signal = np.random.default_rng(12).uniform(-0.5, 0.5, 6 * 16000)
    wav = str(tmp_path / "recW.wav")
    write_wav(wav, signal, 16000)
    lab = tmp_path / "recW.lab"
    lab.write_text("0.20 3.50 sp\n4.00 5.70 sp\n")
    svc = DiarizationService(cfg, plda, transform, extractor=ex,
                             device="cpu")
    httpd, base = _start(svc)
    try:
        code, health = _get(base, "/healthz")
        assert health["audio"] is True and health["backend"] == "cpu"
        code, out, _ = _post(base, {"wav_file": wav, "lab_file": str(lab)})
        assert code == 200, out
        assert out["recording"] == "recW"
        assert out["rttm"].startswith("SPEAKER recW 1 ")
        code, out2, _ = _post(base, {"wav_file": wav,
                                     "vad": [[0.20, 3.50], [4.00, 5.70]]})
        assert code == 200 and out2["rttm"] == out["rttm"]
        wav8 = str(tmp_path / "recW8.wav")
        write_wav(wav8, signal[:8000], 8000)
        code, err, _ = _post(base, {"wav_file": wav8, "vad": [[0.0, 0.5]]})
        assert code == 400 and "sample rate" in err["error"]
        code, err, _ = _post(base, {"wav_file": wav})
        assert code == 400 and "lab_file" in err["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()
    svc2 = DiarizationService(cfg, plda, transform, device="cpu")
    httpd2, base2 = _start(svc2)
    try:
        code, err, _ = _post(base2, {"wav_file": wav, "lab_file": str(lab)})
        assert code == 400 and "x-vector model" in err["error"]
    finally:
        httpd2.shutdown()
        httpd2.server_close()
        svc2.close()


def test_http_server_end_to_end(corpus, offline):
    """healthz, stats, inline and server-local ark requests equal to the
    offline RTTMs, malformed requests 400, unknown paths 404, and 503 with
    Retry-After under the admission bound."""
    off, off_dir = offline
    svc = _service(corpus, batch_window_ms=50.0)
    httpd, base = _start(svc)
    try:
        code, health = _get(base, "/healthz")
        assert code == 200 and health["status"] == "ok"
        assert health["backend"] == "cpu" and health["device"] == "cpu"
        assert health["audio"] is False and health["mesh"] is None
        rec = "rec001"
        x, ts = corpus["recs"][rec]
        code, out, _ = _post(base, {"recording": rec, "xvectors": x.tolist(),
                                    "timestamps": ts.tolist()})
        assert code == 200 and out["rttm"] == _rttm(off_dir, rec)
        assert out["n_speakers"] == off[rec].n_speakers
        code, out, _ = _post(base, {"xvec_ark_file": corpus["ark"],
                                    "segments_file": corpus["segments"]})
        assert code == 200 and set(out["results"]) == set(off)
        for r in off:
            assert out["results"][r]["rttm"] == _rttm(off_dir, r)
        assert "failed" not in out
        code, err, _ = _post(base, {"nonsense": 1})
        assert code == 400 and "error" in err
        for bad in (5, None, "xvectors"):
            code, err, _ = _post(base, bad)
            assert code == 400 and "error" in err, bad
        code, err, _ = _post(base, {"xvec_ark_file": "/nope",
                                    "segments_file": "/nope"})
        assert code == 400 and "error" in err
        code, err, _ = _post(base, {}, path="/elsewhere")
        assert code == 404
        code, stats = _get(base, "/stats")
        assert code == 200 and stats["requests"] >= 1 + len(off)
        with svc._lock:                  # saturate the admission bound
            saved, svc._pending = svc._pending, svc._max_pending
        try:
            code, err, headers = _post(base, {
                "recording": "r", "xvectors": x[:4].tolist(),
                "timestamps": ts[:4].tolist()})
        finally:
            with svc._lock:
                svc._pending = saved
        assert code == 503 and headers.get("Retry-After") == "1"
        assert "max_pending_requests" in err["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()


def test_serve_main_subprocess_sigterm(corpus, offline):
    """Boot the real daemon (python -m vbx_tpu_torch.cli.serve --device
    cpu), serve one ark request, then SIGTERM it: it drains and exits 0."""
    off, off_dir = offline
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "vbx_tpu_torch.cli.serve",
         "--plda-file", corpus["plda"], "--xvec-transform",
         corpus["transform"], "--port", str(port), "--device", "cpu",
         "--warmup-batches", "1,2"],
        env=env, stderr=subprocess.PIPE, cwd=ROOT)
    try:
        base = f"http://127.0.0.1:{port}"
        for _ in range(240):
            try:
                code, health = _get(base, "/healthz")
                assert health["status"] == "ok"
                break
            except OSError:
                time.sleep(0.5)
                assert proc.poll() is None, proc.stderr.read().decode()
        else:
            raise AssertionError("daemon never came up")
        code, out, _ = _post(base, {"xvec_ark_file": corpus["ark"],
                                    "segments_file": corpus["segments"]})
        assert code == 200
        for r in off:
            assert out["results"][r]["rttm"] == _rttm(off_dir, r)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        err = proc.stderr.read()
        assert b"drained and stopped" in err and b"warmup[1, 2]" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serve_cli_refuses_bad_warmup_lists(corpus):
    from vbx_tpu_torch.cli.serve import main

    args = ["--plda-file", corpus["plda"], "--xvec-transform",
            corpus["transform"], "--device", "cpu", "--port", "0"]
    with pytest.raises(SystemExit, match="warmup-batches"):
        main(args + ["--warmup-batches", "1,x"])
    with pytest.raises(SystemExit, match="at least one size"):
        main(args + ["--warmup-batches", "0"])
