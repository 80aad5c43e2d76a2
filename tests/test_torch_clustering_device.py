"""The port's NN-chain walk (vbx_tpu_torch.clustering.device) against
vbx_tpu's device walk and against the float64 host chain, on the same
numpy-seeded inputs, on the CPU: there the wrappers run the plain twin of
csrc/nn_chain.cu (the kernel itself runs in tests/test_torch_gpu.py and
chip_smoke.py), and vbx_tpu's walk runs under XLA:CPU as its own tests run
it.

Contract (tests/test_clustering.py's): sorted merge distances within 1e-6
of vbx_tpu's float32 walk, labels equal at cuts placed at merge-gap
midpoints, the last merge covering N. The port's walk is float64, as the
host chain is: its distances agree with the host's within HOST_BAR (the
dot products are summed in other orders) and its merges are the host's.
A lane's result does not depend on its batch, bit for bit."""

import warnings

import numpy as np
import pytest
import torch

from vbx_tpu.clustering import device as jdev
from vbx_tpu_torch.clustering import (fcluster_by_distance, linkage_dot_avg)
from vbx_tpu_torch.clustering import device as tdev
from vbx_tpu_torch.engine import ahc as tahc
from vbx_tpu_torch.testing import host_threads

DIST_BAR = 1e-6
HOST_BAR = 1e-12


# several test workers share the host: keep this file's pools to one thread
@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    with host_threads(1):
        yield


def _clustered(seed, n, d, k=8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d))
    x = centers[rng.integers(0, k, n)] + 0.5 * rng.standard_normal((n, d))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _same_labels_at_cuts(Z, Zref, qs=(0.3, 0.7)):
    n = len(Zref) + 1
    adjust = abs(Zref[:, 2].min())
    ds = np.sort(Zref[:, 2])
    for q in qs:
        i = int(q * (n - 1))
        cut = 0.5 * (ds[i] + ds[i + 1]) + adjust
        la, lb = (fcluster_by_distance(
            np.c_[z[:, :2], z[:, 2] + adjust, z[:, 3]], cut)
            for z in (Z, Zref))
        np.testing.assert_array_equal(la, lb, err_msg=f"cut at q={q}")


# tests/test_clustering.py's seeds and sizes
@pytest.mark.parametrize("seed,n,d", [(0, 300, 32), (1, 517, 16),
                                      (2, 1024, 64)])
def test_twin_matches_vbx_tpu_walk_and_host_chain(seed, n, d):
    xn = _clustered(seed, n, d)
    Zt = tdev.linkage_dot_avg_device(xn, device="cpu")
    Zj = jdev.linkage_dot_avg_device(xn)
    Zh = linkage_dot_avg(xn)
    assert Zt.shape == (n - 1, 4) and Zt[-1, 3] == n
    for ref, bar in ((Zj, DIST_BAR), (Zh, HOST_BAR)):
        assert np.abs(np.sort(Zt[:, 2]) - np.sort(ref[:, 2])).max() < bar
        _same_labels_at_cuts(Zt, ref)
    # the same lane rules at the host's precision: the host's merges
    np.testing.assert_array_equal(Zt[:, :2], Zh[:, :2])
    np.testing.assert_array_equal(Zt[:, 3], Zh[:, 3])


def test_batched_twin_matches_vbx_tpu_and_host():
    """tests/test_clustering.py's batched case: mixed sizes and a trivial
    single-vector lane; each lane bit-equal to its solo walk."""
    rng = np.random.default_rng(7)
    xns = []
    for n in (300, 517, 801):
        centers = rng.standard_normal((6, 32))
        x = centers[rng.integers(0, 6, n)] \
            + 0.5 * rng.standard_normal((n, 32))
        xns.append(x / np.linalg.norm(x, axis=1, keepdims=True))
    xns.append(xns[0][:1])
    Zb = tdev.linkage_dot_avg_device_batched(xns, device="cpu")
    Zj = jdev.linkage_dot_avg_device_batched(xns)
    for m, xn in enumerate(xns[:3]):
        n = len(xn)
        Zh = linkage_dot_avg(xn)
        assert Zb[m][-1, 3] == n
        for ref, bar in ((Zh, HOST_BAR), (Zj[m], DIST_BAR)):
            assert np.abs(np.sort(ref[:, 2])
                          - np.sort(Zb[m][:, 2])).max() < bar
            _same_labels_at_cuts(Zb[m], ref, qs=(1 / 3,))
        np.testing.assert_array_equal(
            Zb[m], tdev.linkage_dot_avg_device(xn, device="cpu"))
    assert Zb[3].shape == (0, 4)


@pytest.mark.parametrize("ns", [(5, 0, 3, 1, 40), (2,), (64, 63)])
def test_walk_lanes_bit_equal_alone_and_batched(ns):
    """nn_chain_walk: a lane's triples, bad flag and step count are the same
    bits alone and among other lanes (in another order)."""
    D = 12
    M = len(ns)
    sums = np.zeros((M, max(ns), D))
    for m, n in enumerate(ns):
        sums[m, :n] = _clustered(100 + m, n, D, k=3) if n else 0.0
    full = tdev.nn_chain_walk(torch.from_numpy(sums), ns)
    rev = tdev.nn_chain_walk(torch.from_numpy(sums[::-1].copy()), ns[::-1])
    for m, n in enumerate(ns):
        alone = tdev.nn_chain_walk(torch.from_numpy(sums[m:m + 1, :n]),
                                   [n])
        k = max(n - 1, 0)
        for j in range(3):
            assert torch.equal(full[j][m, :k], alone[j][0, :k])
            assert torch.equal(full[j][m, :k], rev[j][M - 1 - m, :k])
        assert bool(full[3][m]) is False
        assert int(full[4][m]) == int(alone[4][0])
        assert int(full[5][m]) == int(alone[5][0])
        # a correct walk takes at most 3 steps a merge
        assert int(full[4][m]) <= 3 * k


def test_walk_counts_the_live_clusters_it_scans():
    """The walk's sixth output sums, over a lane's steps, the live clusters
    the step scans (n - k with k merges made): the rows a bound counts. By
    hand on three points on the axes: push 1, merge (1, 0), push 2, merge
    (2, 0) scan 3, 3, 2 and 2 clusters."""
    sums = torch.tensor([[[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]]],
                        dtype=torch.float64)
    out = tdev.nn_chain_walk(sums, [3])
    assert int(out[4][0]) == 4 and int(out[5][0]) == 10
    assert out[5].dtype == torch.int64
    xn = _clustered(8, 300, 16, k=4)
    out = tdev.nn_chain_walk(torch.from_numpy(xn)[None], [300])
    steps, rows = int(out[4][0]), int(out[5][0])
    assert 2 * steps <= rows <= 300 * steps


def test_trivial_sizes():
    """vbx_tpu's trivial cases: N = 1, N = 3 on the axes, an empty list, and
    N = 0 and N = 2 lanes."""
    assert tdev.linkage_dot_avg_device(np.ones((1, 4)),
                                       device="cpu").shape == (0, 4)
    Z = tdev.linkage_dot_avg_device(
        np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]]), device="cpu")
    Zj = jdev.linkage_dot_avg_device(
        np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]]))
    assert Z.shape == (2, 4) and Z[-1, 3] == 3.0
    np.testing.assert_allclose(Z, Zj, atol=DIST_BAR)
    assert tdev.linkage_dot_avg_device_batched([], device="cpu") == []
    Zs = tdev.linkage_dot_avg_device_batched(
        [np.zeros((0, 3)), np.eye(3)[:2]], device="cpu")
    assert Zs[0].shape == (0, 4)
    np.testing.assert_array_equal(Zs[1], [[0.0, 1.0, 0.0, 2.0]])
    with pytest.raises(ValueError, match="feature dim"):
        tdev.linkage_dot_avg_device_batched([np.eye(3), np.eye(4)],
                                            device="cpu")


def test_walk_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="float64"):
        tdev.nn_chain_walk(torch.zeros((1, 4, 3)), [4])
    f64 = torch.float64
    with pytest.raises(ValueError, match="ns"):
        tdev.nn_chain_walk(torch.zeros((2, 4, 3), dtype=f64), [4])
    with pytest.raises(ValueError, match="ns"):
        tdev.nn_chain_walk(torch.zeros((1, 4, 3), dtype=f64), [5])


def _tripping_walk(sums, ns, blocks_per_sm=0):
    """A walk whose guard trips on every lane it walks."""
    out = tdev.nn_chain_walk_plain(sums, ns)
    return out[:3] + (torch.ones_like(out[3]),) + out[4:]


def test_guard_raises_and_ahc_falls_back_with_vbx_tpus_warning(
        monkeypatch):
    """A tripped guard raises ReducibilityError (a RuntimeError) with
    vbx_tpu's text; ahc_labels' 'auto' route then warns with vbx_tpu's text
    and returns the host chain's labels. The CUDA predicate is patched
    (there is no card here) and the walk runs its twin."""
    xn = _clustered(4, 700, 16, k=5)
    monkeypatch.setattr(tdev, "nn_chain_walk", _tripping_walk)
    with pytest.raises(tdev.ReducibilityError,
                       match=r"reducibility guard tripped on 1/1 "
                             r"recording\(s\) \(f32 near-tie broke the "
                             r"chain invariant\); use the host f64 chain"):
        tdev.linkage_dot_avg_device(xn, device="cpu")
    assert issubclass(tdev.ReducibilityError, RuntimeError)

    monkeypatch.setattr(tahc, "_BLOCKED_MIN_N", 256)
    monkeypatch.setattr(tahc, "_DEVICE_LINKAGE_MIN_N", 512)
    monkeypatch.setattr(tahc, "_on_cuda", lambda device: True)
    monkeypatch.setattr(tahc._try_device_linkage, "fallbacks", 0)
    with pytest.warns(UserWarning, match=r"device linkage failed "
                      r"\(ReducibilityError\(.*\)\); falling back to the "
                      r"host NN-chain"):
        got = tahc.ahc_labels(xn, 0.0, compute_backend="auto", device="cpu")
    assert tahc._try_device_linkage.fallbacks == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want = tahc.ahc_labels(xn, 0.0, compute_backend="host")
    np.testing.assert_array_equal(got, want)


def test_a_failing_walk_propagates_instead_of_falling_back(monkeypatch):
    """Only the guard falls back: a kernel that fails to build (here: nvcc
    missing) raises out of ahc_labels' 'auto' route."""
    xn = _clustered(5, 700, 16, k=5)

    def no_nvcc(*a, **k):
        raise RuntimeError("nvcc failed for nn_chain")

    monkeypatch.setattr(tdev, "nn_chain_walk", no_nvcc)
    monkeypatch.setattr(tahc, "_BLOCKED_MIN_N", 256)
    monkeypatch.setattr(tahc, "_DEVICE_LINKAGE_MIN_N", 512)
    monkeypatch.setattr(tahc, "_on_cuda", lambda device: True)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tahc.ahc_labels(xn, 0.0, compute_backend="auto", device="cpu")


def test_walk_on_a_card_needs_the_kernel_library():
    """nn_chain_walk runs its twin only for CPU tensors: another device
    is refused."""
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdev.nn_chain_walk(torch.zeros((1, 4, 3), dtype=torch.float64,
                                       device="meta"), [4])


def test_walk_sizes_its_scratch_and_shared_memory():
    """The wrapper's sizing of the walk kernel's launch: the exchange
    scratch covers the grid at any blocks_per_sm it may be given (0: the
    kernel's default, one block an SM), and a lane's rows, replicas and
    bitmap must fit one block's shared memory (csrc/nn_chain.cu:Layout):
    16 KB of bitmap at N = 131072, D = 128 fits, D > 4096 or N = 2M do
    not."""
    assert tdev.exchange_blocks(132, 0) == 264
    assert tdev.exchange_blocks(132, 1) == 264
    assert tdev.exchange_blocks(132, 3) == 396
    # tip and predecessor rows, 8 warps' partials twice, two 96-byte
    # replicas, one bit a row
    assert tdev.lane_shared_bytes(16384, 128) == 2048 + 192 + 192 + 2048
    assert tdev.lane_shared_bytes(33, 4) == 64 + 192 + 192 + 8
    tdev._check_walk_shape(131072, 128)
    with pytest.raises(ValueError, match="D=4097"):
        tdev._check_walk_shape(100, 4097)
    with pytest.raises(ValueError, match="shared memory"):
        tdev._check_walk_shape(2_000_000, 128)


def test_walk_refuses_a_negative_grid():
    with pytest.raises(ValueError, match="blocks_per_sm"):
        tdev.nn_chain_walk(torch.zeros((1, 4, 3), dtype=torch.float64), [4],
                           blocks_per_sm=-1)


def test_tuning_variants_apply_to_the_walk_source():
    """scripts/torch_nn_chain_tuning.py makes its variants by text
    substitution of csrc/nn_chain.cu: every substitution finds its text in
    the shipped source (it raises otherwise), and the phase timers add the
    entry point that reads them."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_nn_chain_tuning",
        os.path.join(root, "scripts", "torch_nn_chain_tuning.py"))
    tuning = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tuning)
    src = open(os.path.join(root, "vbx_tpu_torch", "csrc",
                            "nn_chain.cu")).read()
    made = {tag: tuning.variant_source(src, subs)
            for tag, subs in tuning.VARIANTS.items()}
    assert made["shipped"] == src
    assert "nn_chain_phases" in made["phases"]
    assert made["no_sleep"] != src and made["fence"] != src
