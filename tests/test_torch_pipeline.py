"""The port's pipeline end to end (vbx_tpu_torch.engine.pipeline, its CLI and
its file codecs) against vbx_tpu's on a synthetic corpus written by
vbx_tpu_torch.testing: the same ark, segments, PLDA and transform.h5 go
through both packages, on the CPU."""

import dataclasses
import filecmp
import io
import os

import numpy as np
import pytest
import torch

from vbx_tpu.config import get_preset as jpreset
from vbx_tpu.engine import pipeline as jpipe
from vbx_tpu.io import ark as jark, plda as jplda, rttm as jrttm
from vbx_tpu.io import segments as jseg, transform as jtrans
from vbx_tpu_torch.cli.diarize import main as torch_cli
from vbx_tpu_torch.config import get_preset as tpreset
from vbx_tpu_torch.engine import pipeline as tpipe
from vbx_tpu_torch.io import ark as tark, plda as tplda, rttm as trttm
from vbx_tpu_torch.io import segments as tseg, transform as ttrans
from vbx_tpu_torch.testing import (frame_agreement, host_threads,
                                   write_corpus)


# several test workers share the host: keep this file's pools to one thread
@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    with host_threads(1):
        yield

LENGTHS = [150, 600, 320, 450, 230]
SPEAKERS = [2, 5, 3, 4, 3]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("corpus")), 0, LENGTHS,
                        SPEAKERS)


def _files(corpus):
    return (corpus["ark"], corpus["segments"])


def _models(corpus):
    return (corpus["plda"], corpus["transform"])


def _same_rttms(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b))
    assert len(names) == len(LENGTHS)
    for f in names:
        assert filecmp.cmp(os.path.join(dir_a, f), os.path.join(dir_b, f),
                           shallow=False), f


@pytest.mark.parametrize("batch", [True, False])
def test_rttms_byte_equal_to_jax_structured(corpus, tmp_path, batch):
    """Example preset, structured engine (float32), batched and streaming:
    every RTTM byte-equal to vbx_tpu's."""
    out_t = tpipe.diarize_ark(*_files(corpus), str(tmp_path / "t"),
                              tpreset("example"), *_models(corpus),
                              batch=batch, verbose=False, device="cpu")
    jpipe.diarize_ark(*_files(corpus), str(tmp_path / "j"),
                      jpreset("example"), *_models(corpus), batch=batch,
                      verbose=False)
    _same_rttms(tmp_path / "t", tmp_path / "j")
    frames = agree = 0
    for rec, z in corpus["truth"].items():
        frames += len(z)
        agree += len(z) * frame_agreement(z, out_t[rec].labels1st)
    assert agree / frames >= 0.95          # and it finds the speakers


def test_kernel_route_partitions_match_jax_pallas(corpus, tmp_path):
    """Explicit fb_impl='pallas' (the kernel route; its plain twin on the
    CPU, vbx_tpu's interpret-mode kernel) with max_iters=10: label
    partitions agree on >= 99.5% of frames after renaming."""
    cfg_t = tpreset("example")
    cfg_t = cfg_t.replace(vb=dataclasses.replace(cfg_t.vb, max_iters=10))
    cfg_j = jpreset("example")
    cfg_j = cfg_j.replace(vb=dataclasses.replace(cfg_j.vb, max_iters=10))
    out_t = tpipe.diarize_ark(*_files(corpus), str(tmp_path / "t"), cfg_t,
                              *_models(corpus), fb_impl="pallas",
                              verbose=False, device="cpu")
    out_j = jpipe.diarize_ark(*_files(corpus), str(tmp_path / "j"), cfg_j,
                              *_models(corpus), fb_impl="pallas",
                              verbose=False)
    frames = agree = 0
    for rec, o in out_j.items():
        n = len(o.labels1st)
        frames += n
        agree += n * frame_agreement(o.labels1st, out_t[rec].labels1st)
    assert agree / frames >= 0.995


def test_cli_matches_library_call(corpus, tmp_path):
    lib_dir = tmp_path / "lib"
    tpipe.diarize_ark(*_files(corpus), str(lib_dir), tpreset("example"),
                      *_models(corpus), verbose=False, device="cpu")
    rc = torch_cli([
        "--init", "AHC+VB", "--out-rttm-dir", str(tmp_path / "cli"),
        "--xvec-ark-file", corpus["ark"], "--segments-file",
        corpus["segments"], "--xvec-transform", corpus["transform"],
        "--plda-file", corpus["plda"], "--device", "cpu"])
    assert rc == 0
    _same_rttms(lib_dir, tmp_path / "cli")
    # --mesh: the sharded engine on CPU copies writes the same RTTMs
    rc = torch_cli([
        "--init", "AHC+VB", "--out-rttm-dir", str(tmp_path / "m"),
        "--xvec-ark-file", corpus["ark"], "--segments-file",
        corpus["segments"], "--xvec-transform", corpus["transform"],
        "--plda-file", corpus["plda"], "--device", "cpu", "--mesh", "2x1"])
    assert rc == 0
    _same_rttms(lib_dir, tmp_path / "m")


def test_diarizers_built_from_one_parameter_set_agree(corpus):
    """Parameters carried across: both Diarizers take the same numpy
    (mu, tr, psi) and (mean1, lda, mean2) tuples, and their
    re-diagonalized PLDA and transform agree bit for bit in float64."""
    plda, transform = corpus["models"]
    dt = tpipe.Diarizer(tpreset("example"), plda, transform, device="cpu")
    dj = jpipe.Diarizer(jpreset("example"), plda, transform)
    for name in ("plda_mu", "plda_tr", "plda_psi", "mean1", "lda", "mean2",
                 "_vb_tr"):
        a, b = getattr(dt, name), getattr(dj, name)
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b, err_msg=name)
    x_raw = np.random.default_rng(0).standard_normal((50, 256))
    np.testing.assert_array_equal(dt.transform_xvectors(x_raw),
                                  dj.transform_xvectors(x_raw))
    # and the port's own file readers give the same arrays
    for a, b in zip(tplda.read_plda(corpus["plda"]), plda):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ttrans.read_xvec_transform(corpus["transform"]),
                    transform):
        np.testing.assert_array_equal(a, b)


def test_top2_breaks_ties_to_the_lowest_index():
    g = torch.tensor([[[0.4, 0.4, 0.2, 0.0], [0.1, 0.3, 0.3, 0.3],
                       [0.0, 0.0, 0.0, 0.0]]])
    smask = torch.tensor([[True, True, True, False]])
    l1, l2 = tpipe._top2(g, smask)
    assert l1.tolist() == [[0, 1, 0]]
    assert l2.tolist() == [[1, 2, 1]]
    jl1, jl2 = jpipe._top2_device(g.numpy(), smask.numpy())
    assert np.asarray(jl1).tolist() == l1.tolist()
    assert np.asarray(jl2).tolist() == l2.tolist()


@pytest.mark.parametrize("n_lanes", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n_dp", [1, 2, 3])
def test_vb_chunk_masks_and_replica_lanes(corpus, monkeypatch, n_dp,
                                          n_lanes):
    """run_vb_chunk, the one chunk path of the corpus pass, the service and
    the single recording's kernel route, against a chunk built by hand:
    rows stacked, uniform priors and frame/speaker masks over each lane's
    (T, S), the lanes padded to a multiple of 'dp' with replicas of lane 0
    (no mesh at dp = 1), the configured stop rule; its labels, iterations
    and ELBOs are the engine's on that chunk through _top2."""
    from vbx_tpu_torch.parallel import engine as tpeng
    from vbx_tpu_torch.parallel import make_mesh

    cfg = tpreset("example")
    cfg = cfg.replace(vb=dataclasses.replace(cfg.vb, max_iters=3))
    diar = tpipe.Diarizer(cfg, *corpus["models"], device="cpu")
    mesh = make_mesh(n_dp, 1, device="cpu") if n_dp > 1 else None
    rng = np.random.default_rng(n_dp * 10 + n_lanes)
    x = diar.transform_xvectors(rng.standard_normal((256, 256)))
    shapes, xs, gs = [], [], []
    for b in range(n_lanes):
        T, k = (256, 90, 200, 131, 17)[b], (2, 5, 3, 1, 4)[b]
        T_b, S_b, key, Xi, Gi = diar.bucket_planes(x[:T], np.arange(T) % k)
        assert (T_b, S_b, key) == (T, k, (256, 8))
        assert not Xi[T:].any() and not Gi[:, S_b:].any()
        shapes.append((T, S_b))
        xs.append(torch.as_tensor(Xi))
        gs.append(torch.as_tensor(Gi))
    lanes = list(range(n_lanes)) + [0] * (-n_lanes % n_dp)
    pi = np.zeros((len(lanes), 8), np.float32)
    fm = np.zeros((len(lanes), 256), bool)
    sm = np.zeros((len(lanes), 8), bool)
    for lane, b in enumerate(lanes):
        T, S = shapes[b]
        pi[lane, :S], fm[lane, :T], sm[lane, :S] = 1.0 / S, True, True
    seen = {}

    def spy(real):
        def engine(*args, **kw):
            seen["args"], seen["kw"] = args, kw
            return real(*args, **kw)
        return engine

    monkeypatch.setattr(tpipe, "vbx_batched", spy(tpipe.vbx_batched))
    monkeypatch.setattr(tpeng, "vbx_sharded", spy(tpeng.vbx_sharded))
    rows = (list(xs), list(gs))
    l1, l2, res = tpipe.run_vb_chunk(diar, *rows, shapes, 256, 8, None,
                                     mesh)
    assert rows == ([], [])                  # consumed once stacked
    args = seen["args"][1:] if mesh is not None else seen["args"]
    X, phi, G, PI, FM, SM = args
    hand = (torch.stack([xs[b] for b in lanes]),
            torch.as_tensor(diar.plda_psi[:cfg.lda_dim], dtype=torch.float32),
            torch.stack([gs[b] for b in lanes]), torch.as_tensor(pi),
            torch.as_tensor(fm), torch.as_tensor(sm))
    for got, want in zip((X, phi, G, PI, FM, SM), hand):
        assert torch.equal(torch.as_tensor(got), want)
    eps, p_ulps, p_iters = tpipe.effective_vb_stop(cfg, None)
    kw = dict(loop_prob=cfg.vb.loop_prob, Fa=cfg.vb.Fa, Fb=cfg.vb.Fb,
              max_iters=3, epsilon=eps, fb_impl=None, plateau_ulps=p_ulps,
              plateau_iters=p_iters)
    assert {k: seen["kw"][k] for k in kw} == kw
    if mesh is None:
        ref = tpipe.vbx_batched(*hand, device="cpu", **kw)
    else:
        ref = tpeng.vbx_sharded(mesh, *hand, **kw)
    r1, r2 = tpipe._top2(ref.gamma, hand[-1])
    assert l1.shape == (len(lanes), 256) and l1.dtype == torch.int32
    assert torch.equal(l1, r1) and torch.equal(l2, r2)
    assert torch.equal(res.n_iters, ref.n_iters)
    np.testing.assert_array_equal(res.elbo.numpy(), ref.elbo.numpy())


def test_preset_kernel_route_resolves_to_structured_on_cpu():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    ami = tpreset("ami_beamformed")
    assert tpipe.resolve_fb_impl(None, ami, cpu) is None
    assert tpipe.resolve_fb_impl(None, ami, cuda) == "pallas_bf16"
    assert tpipe.resolve_fb_impl("pallas", ami, cpu) == "pallas"
    assert tpipe.effective_vb_stop(ami, "pallas_bf16")[0] == float("-inf")
    assert tpipe.effective_vb_stop(ami, None) == \
        jpipe.effective_vb_stop(jpreset("ami_beamformed"), None)


def test_codecs_write_identical_bytes(tmp_path, corpus):
    rng = np.random.default_rng(3)
    recs = [(f"r_{i:03d}", rng.standard_normal(7).astype(np.float32))
            for i in range(5)]
    outs = []
    for mod in (tark, jark):
        buf = io.BytesIO()
        mod.write_vec_ark(buf, recs)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    rows = [(n, "r", 0.24 * i, 0.24 * i + 1.44) for i, (n, _) in
            enumerate(recs)]
    outs = []
    for mod in (tseg, jseg):
        buf = io.StringIO()
        mod.write_segments(buf, rows)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    st, en, lab = np.array([0.0, 1.0, 2.5]), np.array([1.2, 2.6, 3.0]), \
        np.array([0, 0, 1])
    m_t = trttm.merge_adjacent_labels(st, en, lab)
    m_j = jrttm.merge_adjacent_labels(st, en, lab)
    for a, b in zip(m_t, m_j):
        np.testing.assert_array_equal(a, b)
    outs = []
    for mod in (trttm, jrttm):
        buf = io.StringIO()
        mod.write_rttm(buf, "r", *m_t)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    groups_t = list(tark.read_vec_ark_grouped(corpus["ark"]))
    groups_j = list(jark.group_by_recording(jark.iter_vec_ark(corpus["ark"])))
    assert [g[0] for g in groups_t] == [g[0] for g in groups_j]
    for a, b in zip(groups_t, groups_j):
        np.testing.assert_array_equal(a[2], b[2])
    dt = tseg.read_xvector_timing_dict(corpus["segments"])
    dj = jseg.read_xvector_timing_dict(corpus["segments"])
    assert list(dt) == list(dj)
    for k in dt:
        np.testing.assert_array_equal(dt[k][1], dj[k][1])


def _prestage_patches(monkeypatch):
    """A CUDA device (the predicate patched: there is no card here) and the
    cutoffs lowered so the small corpus is 'AMI-length'; the walk and the
    sweeps run their CPU forms."""
    from vbx_tpu_torch.engine import ahc as tahc
    monkeypatch.setattr(tahc, "_on_cuda", lambda device: True)
    monkeypatch.setattr(tahc, "_BLOCKED_MIN_N", 256)
    monkeypatch.setattr(tahc, "_DEVICE_LINKAGE_MIN_N", 300)


PRE_LENGTHS = [400, 650, 320, 900, 200]
PRE_SPEAKERS = [3, 4, 2, 5, 2]


@pytest.fixture(scope="module")
def pre_corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("pre")), 3, PRE_LENGTHS,
                        PRE_SPEAKERS)


def _stages(runlog):
    import json
    return [json.loads(line) for line in open(runlog)
            if json.loads(line)["event"] == "stages"][-1]


def test_corpus_pre_stage_matches_the_per_recording_route(
        pre_corpus, tmp_path, monkeypatch):
    """The batched path's pre-stage (vbx_tpu/engine/pipeline.py:508-599):
    the 4 eligible recordings (N >= the cutoff) are linked in size groups
    within 2x of their smallest (320, 400 | 650, 900), one walk and one
    batched sweep a group; the RTTMs equal the per-recording route's
    (the same 'auto' routes with the pre-stage off), and the stage log
    says so."""
    from vbx_tpu_torch.clustering import device as tdev
    from vbx_tpu_torch.ops import calibration

    _prestage_patches(monkeypatch)
    groups = []
    real = tdev.linkage_dot_avg_device_batched

    def spy(xns, device=None):
        groups.append(sorted(len(x) for x in xns))
        return real(xns, device=device)

    monkeypatch.setattr(tdev, "linkage_dot_avg_device_batched", spy)
    sweeps = []
    real_sweep = calibration.two_gmm_calib_cosine_device_batched
    monkeypatch.setattr(
        calibration, "two_gmm_calib_cosine_device_batched",
        lambda xns, device=None: (sweeps.append(len(xns)),
                                  real_sweep(xns, device=device))[1])
    runlog = str(tmp_path / "run.jsonl")
    out = tpipe.diarize_ark(pre_corpus["ark"], pre_corpus["segments"],
                            str(tmp_path / "pre"), tpreset("example"),
                            *_models(pre_corpus), verbose=False,
                            device="cpu", runlog_path=runlog)
    assert sorted(groups) == [[320, 400], [650, 900]]
    assert sweeps == [2, 2]
    st = _stages(runlog)
    assert st["pre_linkage_recordings"] == 4 and st["pre_linkage_s"] >= 0
    monkeypatch.setattr(tpipe, "_pre_stage", lambda diar, recs: {})
    ref = tpipe.diarize_ark(pre_corpus["ark"], pre_corpus["segments"],
                            str(tmp_path / "per"), tpreset("example"),
                            *_models(pre_corpus), verbose=False,
                            device="cpu", runlog_path=str(tmp_path / "r2"))
    assert "pre_linkage_recordings" not in _stages(str(tmp_path / "r2"))
    assert len(groups) == 2 + 4                 # the per-recording walks
    for f in sorted(os.listdir(tmp_path / "per")):
        assert filecmp.cmp(tmp_path / "pre" / f, tmp_path / "per" / f,
                           shallow=False), f
    for rec in out:
        np.testing.assert_array_equal(out[rec].labels1st,
                                      ref[rec].labels1st)


def test_corpus_pre_stage_guard_trip_falls_back_per_recording(
        pre_corpus, tmp_path, monkeypatch):
    """A group whose batched walk trips the reducibility guard: every
    recording not linked yet keeps its float64 transform and takes the
    per-recording route (whose walk trips too and falls back to the host
    chain, with vbx_tpu's warnings); the RTTMs are the host route's."""
    from vbx_tpu_torch.clustering import device as tdev

    _prestage_patches(monkeypatch)

    def tripping(sums, ns, blocks_per_sm=0):
        out = tdev.nn_chain_walk_plain(sums, ns)
        return out[:3] + (torch.ones_like(out[3]),) + out[4:]

    monkeypatch.setattr(tdev, "nn_chain_walk", tripping)
    runlog = str(tmp_path / "run.jsonl")
    with pytest.warns(UserWarning, match="batched device linkage failed"):
        tpipe.diarize_ark(pre_corpus["ark"], pre_corpus["segments"],
                          str(tmp_path / "pre"), tpreset("example"),
                          *_models(pre_corpus), verbose=False,
                          device="cpu", runlog_path=runlog)
    assert _stages(runlog)["pre_linkage_recordings"] == 0
    cfg = tpreset("example")
    cfg = cfg.replace(ahc=dataclasses.replace(cfg.ahc,
                                              compute_backend="host"))
    tpipe.diarize_ark(pre_corpus["ark"], pre_corpus["segments"],
                      str(tmp_path / "host"), cfg, *_models(pre_corpus),
                      verbose=False, device="cpu")
    for f in sorted(os.listdir(tmp_path / "host")):
        assert filecmp.cmp(tmp_path / "pre" / f, tmp_path / "host" / f,
                           shallow=False), f


def test_initial_labels_takes_the_precomputed_linkage(pre_corpus):
    """Diarizer.initial_labels(x, precomputed_Z=, precomputed_thr=) cuts
    the given linkage at the given threshold, as vbx_tpu's does."""
    from vbx_tpu_torch.clustering import linkage_dot_avg

    plda, transform = pre_corpus["models"]
    dt = tpipe.Diarizer(tpreset("example"), plda, transform, device="cpu")
    dj = jpipe.Diarizer(jpreset("example"), plda, transform)
    x_raw = np.random.default_rng(4).standard_normal((4500, 256))
    x = dt.transform_xvectors(x_raw)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    Z = linkage_dot_avg(xn)
    for thr in (0.05, 0.3):
        np.testing.assert_array_equal(
            dt.initial_labels(x, precomputed_Z=Z, precomputed_thr=thr),
            dj.initial_labels(x, precomputed_Z=Z, precomputed_thr=thr))
