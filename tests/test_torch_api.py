"""The port's public names against vbx_tpu's: every name that vbx_tpu's
engine, ops, io, metrics, utils, parallel and models packages export
imports from the port's package of the same name, but for an explicit
list of names not ported yet and one kept rename. The names added to
close that gap are held to vbx_tpu's functions on the same seeded inputs:
masked_logsumexp, l2_normalize and cos_similarity (float64 to 1e-12,
float32 to 1e-6), the module-level diarize_xvectors, and ahc_labels'
warning that compute_backend='device' does nothing with PLDA scoring."""

import importlib
import re
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbx_tpu.engine import ahc as jahc
from vbx_tpu.engine import pipeline as jpipe
from vbx_tpu.ops import lse as jlse, similarity as jsim
from vbx_tpu.config import get_preset as jpreset
from vbx_tpu_torch.config import get_preset as tpreset
from vbx_tpu_torch.engine import ahc as tahc
from vbx_tpu_torch.engine import pipeline as tpipe
from vbx_tpu_torch.ops import lse as tlse, similarity as tsim
from vbx_tpu_torch.testing import host_threads, synth_models, synth_recording

PACKAGES = ("engine", "ops", "io", "metrics", "utils", "parallel", "models")

# vbx_tpu names the port does not have yet, and why
NOT_PORTED = {
    "two_gmm_calib_lin": "device 2-GMM calibration: ROADMAP.md section 1, "
                         "item 1",
}
# vbx_tpu name -> the port's: the frame-sharded smoother runs K2, a CUDA
# kernel, not a Pallas one
RENAMED = {"forward_backward_blockwise_pallas":
           "forward_backward_blockwise_kernel"}


def exported(package):
    """The public names vbx_tpu.<package> exports: its __all__, or the
    public names its __init__ binds that are not submodules."""
    mod = importlib.import_module(f"vbx_tpu.{package}")
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items()
                 if not n.startswith("_")
                 and not isinstance(v, types.ModuleType)]
    return sorted(names)


EXPORTS = [(p, n) for p in PACKAGES for n in exported(p)]


@pytest.mark.parametrize("package,name", [
    (p, n) for p, n in EXPORTS if n not in NOT_PORTED])
def test_the_port_exports_vbx_tpus_name(package, name):
    port = importlib.import_module(f"vbx_tpu_torch.{package}")
    ours = RENAMED.get(name, name)
    assert hasattr(port, ours), f"vbx_tpu_torch.{package} lacks {ours}"
    obj = getattr(port, ours)
    assert not isinstance(obj, types.ModuleType)
    ref = getattr(importlib.import_module(f"vbx_tpu.{package}"), name)
    assert callable(obj) == callable(ref)


def test_the_list_of_names_not_ported_is_exact():
    """Each name listed as not ported is exported by vbx_tpu and missing
    from the port: porting one fails this test until it leaves the list."""
    for name in NOT_PORTED:
        where = [p for p, n in EXPORTS if n == name]
        assert where, f"{name} is not a vbx_tpu export"
        for p in where:
            port = importlib.import_module(f"vbx_tpu_torch.{p}")
            assert not hasattr(port, name), f"{name} is ported: unlist it"
    for name in RENAMED:
        assert any(n == name for _, n in EXPORTS)


TOL = {"float64": 1e-12, "float32": 1e-6}


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dim,keepdim", [(-1, False), (0, True), (1, False)])
def test_masked_logsumexp_matches_vbx_tpu(dtype, dim, keepdim):
    rng = np.random.default_rng(1)
    x = (5.0 * rng.standard_normal((6, 7, 9))).astype(dtype)
    mask = rng.uniform(size=x.shape) < 0.6
    mask[0] = False          # a fully masked slice along every dim
    xj, xt = _pair(x)
    got = tlse.masked_logsumexp(xt, torch.from_numpy(mask), dim=dim,
                                keepdim=keepdim).numpy()
    ref = np.asarray(jlse.masked_logsumexp(xj, jnp.asarray(mask), axis=dim,
                                           keepdims=keepdim))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("eps,dim", [(0.0, -1), (1e-32, -1), (0.0, 0)])
def test_l2_normalize_matches_vbx_tpu(dtype, eps, dim):
    x = np.random.default_rng(2).standard_normal((40, 16)).astype(dtype)
    xj, xt = _pair(x)
    got = tsim.l2_normalize(xt, eps=eps, dim=dim).numpy()
    ref = np.asarray(jsim.l2_normalize(xj, eps=eps, axis=dim))
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cos_similarity_matches_vbx_tpu(dtype):
    x = np.random.default_rng(3).standard_normal((70, 128)).astype(dtype)
    x[5] = 0.0               # a zero row: eps keeps it finite
    xj, xt = _pair(x)
    got = tsim.cos_similarity(xt).numpy()
    ref = np.asarray(jsim.cos_similarity(xj))
    assert got.shape == (70, 70) and got.dtype == ref.dtype
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.fixture(scope="module")
def models():
    with host_threads(1):
        yield synth_models(np.random.default_rng(4), n_speakers=120)


def test_module_level_diarize_xvectors(models):
    """The module-level function is the Diarizer's method on a Diarizer
    built for the call, and its labels are vbx_tpu's."""
    plda, transform = models
    x_raw, _ = synth_recording(np.random.default_rng(5), 160, 3)
    cfg = tpreset("example")
    with host_threads(1):
        got = tpipe.diarize_xvectors(x_raw, cfg, plda, transform,
                                     device="cpu")
        ref = tpipe.Diarizer(cfg, plda, transform,
                             device="cpu").diarize_xvectors(x_raw)
        jax_out = jpipe.diarize_xvectors(x_raw, jpreset("example"), plda,
                                         transform)
    np.testing.assert_array_equal(got.labels1st, ref.labels1st)
    np.testing.assert_array_equal(got.labels2nd, ref.labels2nd)
    assert got.n_iters == ref.n_iters > 0
    np.testing.assert_array_equal(got.labels1st, jax_out.labels1st)


def _transformed(models, T, seed):
    _, (mean1, lda, mean2) = models
    x, _ = synth_recording(np.random.default_rng(seed), T, 3)
    y = x.astype(np.float64) - mean1
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    y = y @ lda - mean2
    return y / np.linalg.norm(y, axis=1, keepdims=True)


def test_plda_with_the_device_backend_warns_as_vbx_tpu_does(models):
    plda, _ = models
    x = _transformed(models, 120, seed=6)
    kw = dict(similarity="plda", plda=plda, compute_backend="device")
    with pytest.warns(UserWarning) as jw:
        lj = jahc.ahc_labels(x, -0.015, **kw)
    (text,) = {str(w.message) for w in jw if "has no effect" in str(w.message)}
    with pytest.warns(UserWarning, match=re.escape(text)):
        lt = tahc.ahc_labels(x, -0.015, **kw)
    np.testing.assert_array_equal(lt, lj)
    # the other backends say nothing
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for backend in ("auto", "host"):
            np.testing.assert_array_equal(
                tahc.ahc_labels(x, -0.015, similarity="plda", plda=plda,
                                compute_backend=backend), lt)
