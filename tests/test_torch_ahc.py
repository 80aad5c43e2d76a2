"""The port's AHC host chain and calibration (vbx_tpu_torch.engine.ahc,
vbx_tpu_torch.ops.calibration) against vbx_tpu's, on the same float64
inputs: labels and thresholds bit-equal (the same numpy arithmetic and the
same native library), PLDA scores to float64 roundoff."""

import numpy as np
import pytest
import torch

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
    """compute_backend is validated as in vbx_tpu. With device='cpu' 'auto'
    runs the float64 host chain, and a short 'device' request scores in
    float32 on the CPU and calibrates in float64 on the host, as vbx_tpu's
    'device' does on its CPU backend: the same labels on these inputs.
    'host' and a short 'auto' request never resolve the device; a
    'device' request with no card and no device raises."""
    x = _transformed(models, 400, 3, seed=9)
    ref = tahc.ahc_labels(x, -0.015, compute_backend="host")
    for backend in ("auto", "device"):
        np.testing.assert_array_equal(
            tahc.ahc_labels(x, -0.015, compute_backend=backend,
                            device="cpu"), ref)
    np.testing.assert_array_equal(
        tahc.ahc_labels(x, -0.015, compute_backend="auto"), ref)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tahc.ahc_labels(x, -0.015, compute_backend="device")
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


# -- the device routes (tests/test_ahc.py's routing tests) -----------------


def _centers_x(seed, k, n, d, scale=0.6, noise=0.5):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * scale
    return centers[rng.integers(0, k, n)] + noise * rng.standard_normal(
        (n, d))


def test_precomputed_thr_short_circuits_host_passes(monkeypatch):
    """tests/test_ahc.py:161: with precomputed_Z and precomputed_thr the cut
    is made directly, the same labels as vbx_tpu's, and no O(N^2) host
    pass runs (monkeypatched to raise)."""
    from vbx_tpu_torch.clustering import linkage_dot_avg

    x = _centers_x(9, 4, 600, 16)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    Z = linkage_dot_avg(xn)
    thr = tcal.two_gmm_calib_lin_binned((xn @ xn.T).reshape(-1))
    want = tahc.ahc_labels(x, 0.0)
    monkeypatch.setattr(tahc, "_blocked_cosine_condensed_and_thr",
                        lambda *a, **k: (_ for _ in ()).throw(
                            AssertionError("host pass ran")))
    monkeypatch.setattr(tahc, "_BLOCKED_MIN_N", 512)
    got = tahc.ahc_labels(x, 0.0, precomputed_Z=Z, precomputed_thr=thr)
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(jahc, "_BLOCKED_MIN_N", 512)
    np.testing.assert_array_equal(
        got, jahc.ahc_labels(x, 0.0, precomputed_Z=Z, precomputed_thr=thr))


def test_precomputed_z_without_thr_routes_the_threshold(monkeypatch):
    """precomputed_Z alone: the threshold comes from the host blocked sweep
    below _DEVICE_CALIB_MIN_N (and on a device that is not CUDA)."""
    from vbx_tpu_torch.clustering import linkage_dot_avg

    x = _centers_x(10, 5, 700, 16)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    Z = linkage_dot_avg(xn)
    monkeypatch.setattr(tahc, "_BLOCKED_MIN_N", 512)
    monkeypatch.setattr(jahc, "_BLOCKED_MIN_N", 512)
    got = tahc.ahc_labels(x, 0.0, precomputed_Z=Z, device="cpu")
    np.testing.assert_array_equal(got, tahc.ahc_labels(x, 0.0))
    np.testing.assert_array_equal(got,
                                  jahc.ahc_labels(x, 0.0, precomputed_Z=Z))


def test_long_n_device_route_matches_host_and_vbx_tpu(monkeypatch):
    """tests/test_ahc.py:186: compute_backend='device' at N >= the blocked
    cutoff (the streamed calibration sweep, here on the CPU, and the native
    host linkage, since the device is not CUDA) gives the host chain's
    labels, and vbx_tpu's 'device' route's; 'auto' on the CPU is host. The
    cutoff is lowered in both packages to keep the CPU sweeps short."""
    monkeypatch.setattr(tahc, "_BLOCKED_MIN_N", 1024)
    monkeypatch.setattr(jahc, "_BLOCKED_MIN_N", 1024)
    x = _centers_x(5, 5, 1300, 16)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    host = tahc.ahc_labels(x, 0.0, compute_backend="host")
    dev = tahc.ahc_labels(x, 0.0, compute_backend="device", device="cpu")
    auto = tahc.ahc_labels(x, 0.0, compute_backend="auto", device="cpu")
    np.testing.assert_array_equal(dev, host)
    np.testing.assert_array_equal(auto, host)
    np.testing.assert_array_equal(
        dev, jahc.ahc_labels(x, 0.0, compute_backend="device"))


def test_short_device_route_matches_vbx_tpu():
    """tests/test_ahc.py:337: 'device' below the blocked cutoff scores on
    the device (float32 here; vbx_tpu's CPU backend scores at its x64
    dtype) and calibrates in float64 on the host: on well-separated
    speakers the same 4-way partition as the host chain and vbx_tpu's
    'device' route."""
    import itertools

    rng = np.random.default_rng(5)
    cents = rng.standard_normal((4, 32)) * 5
    x = cents[np.repeat(np.arange(4), 50)] \
        + 0.1 * rng.standard_normal((200, 32))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    host = tahc.ahc_labels(x, -0.015)
    dev = tahc.ahc_labels(x, -0.015, compute_backend="device", device="cpu")
    ref = jahc.ahc_labels(x, -0.015, compute_backend="device")
    assert host.max() == dev.max() == ref.max() == 3
    for other in (host, ref):
        for perm in itertools.permutations(range(4)):
            if np.all(np.array(perm)[other] == dev):
                break
        else:
            raise AssertionError("the device route changed the partition")


def test_auto_routes_mid_n_linkage_to_the_walk(monkeypatch):
    """tests/test_ahc.py:420: under 'auto' on a CUDA device (the predicate
    patched: there is no card here) the band [6144, 16384) runs the host
    threshold and the device walk (a spy, delegating to the host chain);
    explicit 'host' never calls it, nor does a recording below the band —
    the routes vbx_tpu takes."""
    from vbx_tpu_torch.clustering import device as tdev
    from vbx_tpu_torch.clustering import linkage_dot_avg

    calls = []

    def spy(xn, device=None):
        calls.append(len(xn))
        return linkage_dot_avg(xn)

    monkeypatch.setattr(tdev, "linkage_dot_avg_device", spy)
    monkeypatch.setattr(tahc, "_on_cuda", lambda device: True)
    x = _centers_x(0, 6, 6500, 32, scale=1.0)
    lab_auto = tahc.ahc_labels(x, 0.0, compute_backend="auto")
    assert calls == [6500]
    lab_host = tahc.ahc_labels(x, 0.0, compute_backend="host")
    assert calls == [6500]
    np.testing.assert_array_equal(lab_auto, lab_host)
    tahc.ahc_labels(x[:5000], 0.0, compute_backend="auto")
    assert calls == [6500]
    # and the cutoffs are vbx_tpu's
    assert (tahc._BLOCKED_MIN_N, tahc._DEVICE_LINKAGE_MIN_N,
            tahc._DEVICE_CALIB_MIN_N) == (jahc._BLOCKED_MIN_N,
                                          jahc._DEVICE_LINKAGE_MIN_N,
                                          jahc._DEVICE_CALIB_MIN_N)


def test_auto_routes_long_n_calibration_to_the_device(monkeypatch):
    """From _DEVICE_CALIB_MIN_N (patched down) 'auto' on a CUDA device
    takes the device sweep and the walk; a sweep that fails propagates
    (no host fallback: only the walk's guard falls back)."""
    from vbx_tpu_torch.clustering import device as tdev
    from vbx_tpu_torch.clustering import linkage_dot_avg
    from vbx_tpu_torch.ops import calibration

    seen = []
    monkeypatch.setattr(tdev, "linkage_dot_avg_device",
                        lambda xn, device=None: (seen.append("walk"),
                                                 linkage_dot_avg(xn))[1])
    real = calibration.two_gmm_calib_cosine_device
    monkeypatch.setattr(calibration, "two_gmm_calib_cosine_device",
                        lambda xn, device=None: (seen.append("sweep"),
                                                 real(xn, device="cpu"))[1])
    monkeypatch.setattr(tahc, "_on_cuda", lambda device: True)
    monkeypatch.setattr(tahc, "_BLOCKED_MIN_N", 256)
    monkeypatch.setattr(tahc, "_DEVICE_LINKAGE_MIN_N", 300)
    monkeypatch.setattr(tahc, "_DEVICE_CALIB_MIN_N", 500)
    x = _centers_x(3, 5, 900, 16)
    got = tahc.ahc_labels(x, 0.0, compute_backend="auto")
    assert seen == ["sweep", "walk"]
    np.testing.assert_array_equal(
        got, tahc.ahc_labels(x, 0.0, compute_backend="host"))

    def oom(xn, device=None):
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(calibration, "two_gmm_calib_cosine_device", oom)
    with pytest.raises(RuntimeError, match="out of memory"):
        tahc.ahc_labels(x, 0.0, compute_backend="auto")


def test_a_cuda_build_error_propagates_instead_of_falling_back(
        monkeypatch):
    """A walk kernel that fails to build raises out of the 'auto' route
    (vbx_tpu would warn and run the host chain)."""
    from vbx_tpu_torch.clustering import device as tdev
    from vbx_tpu_torch.ops import cuda_build

    def no_nvcc(*a, **k):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built on this machine")

    monkeypatch.setattr(cuda_build, "library", no_nvcc)
    # the wrapper takes its kernel path (the tensor's device is not the
    # CPU), where the build is reached
    monkeypatch.setattr(tdev, "nn_chain_walk",
                        lambda sums, ns: tdev._launcher())
    monkeypatch.setattr(tahc, "_on_cuda", lambda device: True)
    x = _centers_x(1, 5, 6200, 16)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tahc.ahc_labels(x, 0.0, compute_backend="auto", device="cpu")
