"""The port's spans and counters on the CPU: `utils.profiling.annotate`'s
stage log, the `vbx.` spans that diarize_ark and extract_to_ark leave in a
torch.profiler trace, the runlog `stages` event's span seconds and walk
and ark read deltas, and nn_chain_walk's cumulative counters."""

import dataclasses
import gzip
import json
import os
import time

import numpy as np
import pytest
import torch

from vbx_tpu_torch.clustering import device as cdev
from vbx_tpu_torch.config import get_preset
from vbx_tpu_torch.engine import pipeline
from vbx_tpu_torch.utils import profiling
from vbx_tpu_torch.testing import host_threads, write_corpus


# several test workers share the host: keep this file's pools to one thread
@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    with host_threads(1):
        yield


def _spans(log_dir):
    """The names of the `user_annotation` events of the one trace under
    `log_dir`."""
    (path,) = log_dir.glob("*.pt.trace.json.gz")
    with gzip.open(path, "rt") as f:
        return [e["name"] for e in json.load(f)["traceEvents"]
                if e.get("cat") == "user_annotation"]


def _preset():
    """The example preset at one VB iteration: the profiler records every
    op of the CPU's structured smoother, and one iteration shows them all."""
    cfg = get_preset("example")
    return cfg.replace(vb=dataclasses.replace(cfg.vb, max_iters=1))


def _stages(runlog):
    return [json.loads(line) for line in open(runlog)
            if json.loads(line)["event"] == "stages"]


def test_annotate_adds_each_span_to_its_key():
    log = {}
    for _ in range(3):
        with profiling.annotate("vbx.test", log, "a_s"):
            time.sleep(0.01)
    with profiling.annotate("vbx.test", log, "b_s"):
        pass
    with pytest.raises(ValueError):
        with profiling.annotate("vbx.test", log, "b_s"):
            raise ValueError("a span that raises still counts")
    assert set(log) == {"a_s", "b_s"}
    assert 0.03 <= log["a_s"] < 1.0 and 0 < log["b_s"] < log["a_s"]
    with profiling.annotate("vbx.test"):     # no log: a span alone
        pass


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("corpus")), 5,
                        [160, 240, 200], [2, 3, 2])


def test_batched_pass_leaves_its_spans_and_stage_seconds(corpus, tmp_path):
    runlog = str(tmp_path / "run.jsonl")
    with profiling.trace(str(tmp_path / "trace")):
        pipeline.diarize_ark(corpus["ark"], corpus["segments"],
                             str(tmp_path / "rttm"), _preset(),
                             corpus["plda"], corpus["transform"],
                             verbose=False, device="cpu", runlog_path=runlog)
    names = _spans(tmp_path / "trace")
    for span in ("vbx.entry.read", "vbx.init", "vbx.vb.chunk",
                 "vbx.vb.tail", "vbx.entry.write"):
        assert span in names, span
    assert names.count("vbx.entry.read") == 1
    assert "vbx.pre" in names             # the span opens; no stage runs
    (st,) = _stages(runlog)
    assert {"init_s", "vb_s", "buckets", "vb_chunks_overlapped", "read_s",
            "write_s", "walk"} <= set(st)
    assert "pre_linkage_s" not in st      # no pre-stage on the CPU
    for k in ("init_s", "vb_s", "read_s", "write_s"):
        assert st[k] >= 0 and st[k] == round(st[k], 3), k
    assert st["walk"]["launches"] == 0 and st["walk"]["lanes"] == 0
    assert [json.loads(line)["event"] for line in open(runlog)][-2:] == \
        ["stages", "summary"]             # written after the RTTM loop


def test_batched_pass_writes_the_read_counters(tmp_path):
    """A batched pass over the main path's corpus (fixed-width keys) writes
    the ark readers' deltas as stages.read: every record of the ark, a
    run a recording, all but each run's first located in bulk."""
    from vbx_tpu.io.ark import iter_vec_ark
    from vbx_tpu_torch.testing import MAIN_PATH_RECORDINGS, main_path_corpus

    c = main_path_corpus(str(tmp_path / "c"))
    runlog = str(tmp_path / "run.jsonl")
    pipeline.diarize_ark(c["ark"], c["segments"], str(tmp_path / "rttm"),
                         _preset(), c["plda"], c["transform"], batch=True,
                         verbose=False, device="cpu", runlog_path=runlog)
    (st,) = _stages(runlog)
    n = sum(1 for _ in iter_vec_ark(c["ark"]))
    assert st["read"] == {"records": n, "bytes": os.path.getsize(c["ark"]),
                          "bulk": n - MAIN_PATH_RECORDINGS,
                          "walked": MAIN_PATH_RECORDINGS,
                          "runs": MAIN_PATH_RECORDINGS}


def test_nn_chain_walk_counts_lanes_steps_and_rows():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 12, 5))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    ns = [12, 7, 1]
    before = cdev.walk_counters()
    out = cdev.nn_chain_walk(torch.from_numpy(x), ns)
    after = cdev.walk_counters()
    steps, rows = out[4].numpy().astype(np.int64), out[5].numpy()
    assert steps[0] > 0 and steps[2] == 0
    assert after["launches"] == before["launches"]   # the twin, no kernel
    assert after["lanes"] - before["lanes"] == 3
    assert after["steps"] - before["steps"] == steps.sum()
    assert after["rows"] - before["rows"] == rows.sum()
    assert after["step_n"] - before["step_n"] == int(steps @ ns)
    assert cdev.nn_chain_walk.D == 5


def test_pre_stage_pass_writes_the_walk_deltas(tmp_path, monkeypatch):
    """The pre-stage forced on the CPU (a CUDA device patched in, the
    cutoffs lowered; the walk runs its CPU twin): the stages event carries
    the walk counters' deltas over the pass, and the pre-stage's spans are
    in the trace."""
    from vbx_tpu_torch.engine import ahc

    monkeypatch.setattr(ahc, "_on_cuda", lambda device: True)
    monkeypatch.setattr(ahc, "_BLOCKED_MIN_N", 100)
    monkeypatch.setattr(ahc, "_DEVICE_LINKAGE_MIN_N", 120)
    c = write_corpus(str(tmp_path / "c"), 3, [140, 200, 130, 80],
                     [3, 4, 2, 2])
    walked = []
    real = cdev.nn_chain_walk

    def spy(sums, ns, blocks_per_sm=0):
        out = real(sums, ns, blocks_per_sm)
        walked.append((list(ns), sums.shape[2], out[4].numpy().copy(),
                       out[5].numpy().copy()))
        return out

    monkeypatch.setattr(cdev, "nn_chain_walk", spy)
    launches0 = real.launches
    runlog = str(tmp_path / "run.jsonl")
    with profiling.trace(str(tmp_path / "trace")):
        pipeline.diarize_ark(c["ark"], c["segments"], str(tmp_path / "rttm"),
                             _preset(), c["plda"],
                             c["transform"], verbose=False, device="cpu",
                             runlog_path=runlog)
    (st,) = _stages(runlog)
    assert st["pre_linkage_recordings"] == 3
    walk = st["walk"]
    assert walk["launches"] == real.launches - launches0 == 0
    assert walk["lanes"] == sum(len(ns) for ns, _, _, _ in walked) == 3
    assert walk["steps"] == sum(int(s.sum()) for _, _, s, _ in walked) > 0
    assert walk["rows"] == sum(int(r.sum()) for _, _, _, r in walked)
    assert walk["step_n"] == sum(int(s.astype(np.int64) @ ns)
                                 for ns, _, s, _ in walked)
    assert walk["D"] == walked[-1][1]
    names = _spans(tmp_path / "trace")
    for span in ("vbx.pre", "vbx.pre.transform", "vbx.ahc.walk",
                 "vbx.ahc.finalize", "vbx.pre.calibrate"):
        assert span in names, span


def test_extract_to_ark_leaves_its_four_spans(tmp_path):
    from vbx_tpu_torch.engine.extractor import XVectorExtractor, \
        dither_counters, extract_to_ark
    from vbx_tpu_torch.models.resnet import Bottleneck, ResNetXVector
    from vbx_tpu_torch.testing import write_audio_corpus

    names, wavs, labs = write_audio_corpus(str(tmp_path), 3, [3.0])
    torch.manual_seed(0)
    model = ResNetXVector(Bottleneck, (1, 1, 1, 1), m_channels=8,
                          feat_dim=64, embed_dim=32)
    ext = XVectorExtractor(model, 16000, batch_size=8, device="cpu")
    before = dither_counters()
    with profiling.trace(str(tmp_path / "trace")):
        counts = extract_to_ark(wavs, labs, names, str(tmp_path / "x.ark"),
                                str(tmp_path / "x.seg"), ext)
    assert min(counts.values()) > 0
    spans = _spans(tmp_path / "trace")
    for span in ("vbx.extract.load_wait", "vbx.extract.features",
                 "vbx.extract.embed", "vbx.extract.write"):
        assert spans.count(span) == 1, span
    # the 16-bit wav's samples, dithered on the device against noise drawn
    # once for the new extractor
    assert dither_counters(before) == {
        "files": 1, "samples": 3 * 16000, "noise_draws": 1,
        "noise_samples": 3 * 16000, "host_int_files": 0}
