"""The port's device calibration routes (vbx_tpu_torch.ops.calibration:
two_gmm_calib_lin, two_gmm_calib_with_llrs, two_gmm_calib_cosine_device and
its batched form) against vbx_tpu's on the same numpy-seeded inputs, on the
CPU (vbx_tpu's run under XLA:CPU with x64 on, as its own tests run them).

Bars: float64 EM thresholds within 1e-10 (the same updates, reductions
summed in other orders); float32 within 1e-5; float64 llrs within 1e-8 x
their scale. The cosine sweeps take float32 scores and float32 per-block
sums against vbx_tpu's: within 1e-6 of vbx_tpu's sweep, and within 5e-5 of
the host float64 blocked sweep (tests/test_ahc.py's bar); batched within
1e-6 of single (the group's padding regroups the float32 block sums,
vbx_tpu's documented bound)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbx_tpu.ops import calibration as jcal
from vbx_tpu_torch.engine.ahc import _blocked_cosine_condensed_and_thr
from vbx_tpu_torch.ops import calibration as tcal
from vbx_tpu_torch.testing import host_threads


# several test workers share the host: keep this file's pools to one thread
@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    with host_threads(1):
        yield


def _scores(seed, n0=4000, n1=900):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0.1, 0.05, n0),
                           rng.normal(0.5, 0.08, n1)])


def _xn(seed, n, d, k=4, spread=0.7):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((k, d)) * 0.5
    x = c[rng.integers(0, k, n)] + spread * rng.standard_normal((n, d))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("dtype,bar", [(np.float64, 1e-10),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("seed", [2, 3])
def test_two_gmm_calib_lin_matches_vbx_tpu(dtype, bar, seed):
    s = _scores(seed).astype(dtype)
    got = tcal.two_gmm_calib_lin(torch.from_numpy(s))
    want = float(jcal.two_gmm_calib_lin(jnp.asarray(s)))
    assert got.dtype == torch.from_numpy(s).dtype and got.dim() == 0
    assert abs(float(got) - want) < bar, (float(got), want)
    # a score matrix is flattened, as in vbx_tpu
    sq = s[:4900].reshape(70, 70)
    assert abs(float(tcal.two_gmm_calib_lin(torch.from_numpy(sq)))
               - float(jcal.two_gmm_calib_lin(jnp.asarray(sq)))) < bar
    # and the host float64 EM agrees with the device EM in float64
    if dtype == np.float64:
        assert abs(float(got) - tcal.two_gmm_calib_lin_np(s)) < 1e-9


@pytest.mark.parametrize("niters", [1, 2, 20])
def test_two_gmm_calib_with_llrs_matches_vbx_tpu(niters):
    """llrs from the parameters ENTERING the last iteration, threshold from
    the post-loop ones."""
    s = _scores(4)
    thr_t, llr_t = tcal.two_gmm_calib_with_llrs(torch.from_numpy(s), niters)
    thr_j, llr_j = jcal.two_gmm_calib_with_llrs(jnp.asarray(s), niters)
    assert abs(float(thr_t) - float(thr_j)) < 1e-10
    llr_j = np.asarray(llr_j)
    np.testing.assert_allclose(llr_t.numpy(), llr_j, rtol=0,
                               atol=1e-8 * np.abs(llr_j).max())
    thr_plain = float(tcal.two_gmm_calib_lin(torch.from_numpy(s), niters))
    assert float(thr_t) == pytest.approx(thr_plain, abs=1e-12)
    with pytest.raises(ValueError, match="niters"):
        tcal.two_gmm_calib_with_llrs(torch.from_numpy(s), 0)


@pytest.mark.parametrize("n,d", [(1500, 24), (700, 32)])
def test_cosine_sweep_matches_vbx_tpu_and_host(n, d):
    xn = _xn(n, n, d)
    got = tcal.two_gmm_calib_cosine_device(xn, device="cpu")
    want = jcal.two_gmm_calib_cosine_device(xn)
    _, thr_h = _blocked_cosine_condensed_and_thr(xn, want_condensed=False)
    assert abs(got - want) < 1e-6, (got, want)
    assert abs(got - thr_h) < 5e-5, (got, thr_h)


def test_batched_cosine_sweep_matches_single_vbx_tpu_and_host():
    xns = [_xn(7 + i, n, 32) for i, n in enumerate((600, 900, 1300))]
    got = tcal.two_gmm_calib_cosine_device_batched(xns, device="cpu")
    want = jcal.two_gmm_calib_cosine_device_batched(xns)
    assert got.shape == (3,) and got.dtype == np.float64
    for m, xn in enumerate(xns):
        single = tcal.two_gmm_calib_cosine_device(xn, device="cpu")
        thr_h = tcal.two_gmm_calib_lin_binned((xn @ xn.T).reshape(-1))
        assert abs(got[m] - single) < 1e-6, (m, got[m], single)
        assert abs(got[m] - want[m]) < 1e-6, (m, got[m], want[m])
        assert abs(got[m] - thr_h) < 5e-5, (m, got[m], thr_h)
    assert tcal.two_gmm_calib_cosine_device_batched(
        [], device="cpu").shape == (0,)


def test_degenerate_lanes_freeze_to_their_mean():
    """A lane of identical vectors (every cosine 1) returns its mean without
    touching its neighbour, in the batched form as in the single form and
    in vbx_tpu's."""
    xn = _xn(5, 600, 32)
    degen = np.tile(xn[:1], (500, 1))
    got = tcal.two_gmm_calib_cosine_device_batched([degen, xn],
                                                   device="cpu")
    want = jcal.two_gmm_calib_cosine_device_batched([degen, xn])
    np.testing.assert_allclose(got[0], 1.0, atol=1e-5)
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    single = tcal.two_gmm_calib_cosine_device(xn, device="cpu")
    assert abs(got[1] - single) < 1e-6
    np.testing.assert_allclose(
        tcal.two_gmm_calib_cosine_device(degen, device="cpu"), 1.0,
        atol=1e-5)


def test_sweep_partials_count_every_valid_entry():
    """The sweep's init pass (d = c = 0): g1 = 1/2 over exactly N^2 valid
    entries, and the score sums equal xn @ xn.T's, whatever the padding."""
    xn = _xn(9, 300, 16).astype(np.float32)
    x = torch.zeros((2, 1024, 16))
    x[0, :300] = torch.from_numpy(xn)
    x[1, :200] = torch.from_numpy(xn[:200])
    ns = torch.tensor([300, 200])
    zero = torch.zeros(2)
    parts = tcal._cosine_sweep(x, ns, zero, zero, 256)
    assert parts.shape == (2, 4, 5)
    tot = parts.double().sum(1).numpy()
    s0 = xn.astype(np.float64) @ xn.T.astype(np.float64)
    np.testing.assert_allclose(tot[:, 0], [300 ** 2 / 2, 200 ** 2 / 2])
    np.testing.assert_allclose(tot[0, 3], s0.sum(), rtol=1e-5)
    np.testing.assert_allclose(tot[1, 4], (s0[:200, :200] ** 2).sum(),
                               rtol=1e-5)
