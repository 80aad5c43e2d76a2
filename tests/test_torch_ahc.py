"""The port's AHC host chain and calibration (vbx_tpu_torch.engine.ahc,
vbx_tpu_torch.ops.calibration) against vbx_tpu's, on the same float64
inputs: labels and thresholds bit-equal (the same numpy arithmetic and the
same native library), PLDA scores to float64 roundoff."""

import numpy as np
import pytest

from vbx_tpu.engine import ahc as jahc
from vbx_tpu.ops import calibration as jcal
from vbx_tpu.ops.similarity import kaldi_plda_scoring_dense as jplda
from vbx_tpu_torch.engine import ahc as tahc
from vbx_tpu_torch.ops import calibration as tcal
from vbx_tpu_torch.ops.similarity import kaldi_plda_scoring_dense as tplda
from vbx_tpu_torch.testing import host_threads, synth_models, synth_recording


# several test workers share the host: keep this file's pools to one thread
@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    with host_threads(1):
        yield


@pytest.fixture(scope="module")
def models():
    return synth_models(np.random.default_rng(0))


def _transformed(models, T, K, seed):
    """PLDA-space unit vectors of a synthetic recording (the Diarizer's
    float64 transform)."""
    _, (mean1, lda, mean2) = models
    x, _ = synth_recording(np.random.default_rng(seed), T, K)
    y = x.astype(np.float64) - mean1
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    y = y @ lda - mean2
    return y / np.linalg.norm(y, axis=1, keepdims=True)


# N below and above _BLOCKED_MIN_N = 4096 (the streamed blocked sweep)
@pytest.mark.parametrize("T", [700, 4300])
def test_cosine_labels_and_threshold_bit_equal(models, T):
    x = _transformed(models, T, 5, seed=T)
    lt = tahc.ahc_labels(x, -0.015)
    lj = jahc.ahc_labels(x, -0.015)
    np.testing.assert_array_equal(lt, lj)
    assert len(np.unique(lt)) > 1
    xn = x / (np.sqrt((x * x).sum(axis=1, keepdims=True)) + 1e-32)
    if T >= tahc._BLOCKED_MIN_N:
        _, thr_t = tahc._blocked_cosine_condensed_and_thr(
            xn, want_condensed=False)
        _, thr_j = jahc._blocked_cosine_condensed_and_thr(
            xn, want_condensed=False)
        # and the condensed-matrix route of the same sweep
        ct, thr_t2 = tahc._blocked_cosine_condensed_and_thr(xn)
        cj, thr_j2 = jahc._blocked_cosine_condensed_and_thr(xn)
        np.testing.assert_array_equal(ct, cj)
        assert thr_t2 == thr_j2
    else:
        thr_t = tcal.two_gmm_calib_lin_binned(xn @ xn.T)
        thr_j = jcal.two_gmm_calib_lin_binned(xn @ xn.T)
    assert thr_t == thr_j


@pytest.mark.parametrize("T", [300, 4200])
def test_plda_labels_equal(models, T):
    """Dense PLDA scoring: the port scores in float64 torch, vbx_tpu in
    float64 JAX (x64 is on in tests); the products' summation order
    differs, so scores and thresholds agree to ~1e-12 relative and the
    labels exactly."""
    plda, _ = models
    x = _transformed(models, T, 4, seed=T + 1)
    st = tplda(plda, x, target_energy=1.0)
    sj = jplda(plda, x, target_energy=1.0)
    np.testing.assert_allclose(st, sj, rtol=1e-12, atol=1e-12 * np.abs(
        sj).max())
    np.testing.assert_allclose(tcal.two_gmm_calib_lin_binned(st),
                               jcal.two_gmm_calib_lin_binned(sj), rtol=1e-10)
    lt = tahc.ahc_labels(x, -0.015, similarity="plda", plda=plda)
    lj = jahc.ahc_labels(x, -0.015, similarity="plda", plda=plda)
    np.testing.assert_array_equal(lt, lj)


def test_device_backend_requests_run_the_host_chain(models):
    """compute_backend is validated as in vbx_tpu; every accepted value
    runs the float64 host chain in the port."""
    x = _transformed(models, 400, 3, seed=9)
    ref = tahc.ahc_labels(x, -0.015, compute_backend="host")
    for backend in ("auto", "device"):
        np.testing.assert_array_equal(
            tahc.ahc_labels(x, -0.015, compute_backend=backend), ref)
    with pytest.raises(ValueError, match="compute_backend"):
        tahc.ahc_labels(x, -0.015, compute_backend="Host")


def test_smoothing_and_random_labels_equal():
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 6, size=500)
    for smoothing in (5.0, 7.0):
        np.testing.assert_array_equal(
            tahc.smooth_labels_to_gamma(labels, smoothing),
            jahc.smooth_labels_to_gamma(labels, smoothing))
    np.testing.assert_array_equal(
        tahc.smooth_labels_to_gamma(labels, 5.0, n_speakers=9),
        jahc.smooth_labels_to_gamma(labels, 5.0, n_speakers=9))
    np.testing.assert_array_equal(tahc.random_labels(300, 8, seed=3),
                                  jahc.random_labels(300, 8, seed=3))


def test_calibration_numpy_paths_equal():
    rng = np.random.default_rng(2)
    scores = np.concatenate([rng.normal(0.1, 0.05, 40000),
                             rng.normal(0.5, 0.08, 9000)])
    small = scores[:3000]
    assert tcal.two_gmm_calib_lin_np(small) == jcal.two_gmm_calib_lin_np(
        small)
    big = np.concatenate([scores] * 6)           # > 2^18: the binned route
    assert tcal.two_gmm_calib_lin_binned(big) == \
        jcal.two_gmm_calib_lin_binned(big)
    assert tcal.two_gmm_calib_lin_binned(big, n_bins=1 << 13) == \
        jcal.two_gmm_calib_lin_binned(big, n_bins=1 << 13)
    for n in (10, 5000, 10 ** 6, 10 ** 9):
        assert tcal.adaptive_bins(n) == jcal.adaptive_bins(n)
    cnt, edges = np.histogram(scores, bins=300)
    idx = np.clip(np.searchsorted(edges, scores, side="right") - 1, 0, 299)
    ssum = np.bincount(idx, weights=scores, minlength=300)
    s2sum = np.bincount(idx, weights=scores ** 2, minlength=300)
    assert tcal.two_gmm_calib_from_moments(cnt, ssum, s2sum) == \
        jcal.two_gmm_calib_from_moments(cnt, ssum, s2sum)
    # degenerate scores: both return the common value
    flat = np.full(1000, 0.25)
    assert tcal.two_gmm_calib_lin_np(flat) == jcal.two_gmm_calib_lin_np(
        flat) == 0.25
    # the numpy reference loop itself (the native twin normally answers)
    w = np.ones(small.size)
    from vbx_tpu_torch import clustering
    native = tcal._weighted_em_threshold(w, small, small * small, small, 20)
    lib = clustering._lib
    clustering._lib = None
    clustering._lib_failed = True
    try:
        plain_t = tcal._weighted_em_threshold(w, small, small * small, small,
                                              20)
    finally:
        clustering._lib, clustering._lib_failed = lib, False
    np.testing.assert_allclose(plain_t, native, rtol=1e-12)
