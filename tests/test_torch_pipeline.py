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
    groups_t = list(tark.group_by_recording(tark.iter_vec_ark(corpus["ark"])))
    groups_j = list(jark.group_by_recording(jark.iter_vec_ark(corpus["ark"])))
    assert [g[0] for g in groups_t] == [g[0] for g in groups_j]
    for a, b in zip(groups_t, groups_j):
        np.testing.assert_array_equal(a[2], b[2])
    dt = tseg.read_xvector_timing_dict(corpus["segments"])
    dj = jseg.read_xvector_timing_dict(corpus["segments"])
    assert list(dt) == list(dj)
    for k in dt:
        np.testing.assert_array_equal(dt[k][1], dj[k][1])
