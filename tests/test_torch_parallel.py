"""The port's sharded engine (vbx_tpu_torch.parallel and the K2 kernel's
plain twin) against vbx_tpu's on the same seeded inputs, on the CPU.

vbx_tpu runs on the 8 virtual CPU devices of tests/conftest.py under
shard_map, its Pallas kernels in interpret mode (as tests/test_parallel.py
runs them); the port runs on a mesh of CPU copies, where its kernel
wrappers run their plain twins. Tolerances are stated per test: the bars of
tests/test_parallel.py wherever a test mirrors one there.
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from vbx_tpu import parallel as jpar
from vbx_tpu.ops.fb_pallas import fb_fwd_product_pallas_sb
from vbx_tpu.ops.forward_backward import forward_backward_structured as jseq
from vbx_tpu.parallel.fb_blockwise import _auto_segments as j_auto_segments
from vbx_tpu_torch import parallel as tpar
from vbx_tpu_torch.cli.diarize import main as torch_cli
from vbx_tpu_torch.config import get_preset
from vbx_tpu_torch.engine import pipeline as tpipe
from vbx_tpu_torch.ops import fb_product_kernel as k2
from vbx_tpu_torch.parallel.fb_blockwise import _auto_segments
from vbx_tpu_torch.testing import host_threads, write_corpus

from .oracle import random_hmm_problem, random_vb_problem

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


# several test workers share the host: keep this file's pools to one thread
@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    with host_threads(1):
        yield


def _cpu_mesh(n_dp, n_sp):
    return tpar.make_mesh(n_dp, n_sp, device="cpu")


# ---- 1. K2's plain twin vs vbx_tpu's kernel in interpret mode ------------

# relative bars on fhat (to each row's max) and ls (to max(1, |ls|)): the
# two walks differ only in summation order (measured ~1e-7 / 3e-7)
K2_BARS = {"float32": 1e-6, "bfloat16": 1e-5}


def _k2_inputs(B, Tb, S, R, seed, loop_prob=0.9):
    """[B, Tb, S] emission weights (max 1 per frame) with lane 1's last 40%
    of frames all zero (trailing dead frames and, at R=4, dead segments)
    and lane 2's last speaker absent; finit rows e_i for segment 0 (the
    global first frame) and the folded transition lp * e_i + col for the
    other segments."""
    rng = np.random.default_rng(seed)
    log_p = np.stack([random_hmm_problem(rng, Tb, S)[0] for _ in range(B)])
    w = np.exp(log_p - log_p.max(2, keepdims=True)).astype(np.float32)
    w[1, int(0.6 * Tb):] = 0.0
    w[2, :, -1] = 0.0
    pi = rng.dirichlet(np.ones(S), size=B)
    col = ((1 - loop_prob) * pi + 1e-8).astype(np.float32)
    eye = np.eye(S, dtype=np.float32)
    finit = np.broadcast_to(loop_prob * eye + col[:, None, :],
                            (R, B, S, S)).copy()
    finit[0] = eye
    return w, col, finit


def _k2_jax(w, col, finit, loop_prob, io):
    """vbx_tpu's kernel on its S-fold lane-replicated stream (lane
    r*B*S + b*S + i), as parallel/fb_blockwise.py builds it."""
    B, Tb, S = w.shape
    R = finit.shape[0]
    Ts = Tb // R
    w_seg = w.reshape(B, R, Ts, S).transpose(2, 3, 1, 0).reshape(Ts, S, R * B)
    w1 = np.repeat(w_seg, S, axis=2)
    col1 = np.repeat(np.tile(col.T, (1, R)), S, axis=1)
    finit1 = finit.transpose(3, 0, 1, 2).reshape(S, R * B * S)
    fhat, ls = fb_fwd_product_pallas_sb(
        jnp.asarray(w1), jnp.asarray(col1), jnp.asarray(finit1), loop_prob,
        interpret=True, io_dtype=getattr(jnp, io))
    return (np.asarray(fhat).reshape(S, R, B, S).transpose(1, 2, 3, 0),
            np.asarray(ls).reshape(R, B, S))


@pytest.mark.parametrize("io", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [5, 31])
@pytest.mark.parametrize("R", [1, 4])
def test_k2_plain_twin_matches_pallas_interpret(io, S, R):
    bar = K2_BARS[io]
    w, col, finit = _k2_inputs(3, 64, S, R, seed=S + R)
    fj, lj = _k2_jax(w, col, finit, 0.9, io)
    before = k2.fb_fwd_product_sb.launches
    ft, lt = k2.fb_fwd_product_sb(
        torch.from_numpy(w).to(getattr(torch, io)), torch.from_numpy(col),
        torch.from_numpy(finit), 0.9)
    assert k2.fb_fwd_product_sb.launches == before      # the twin ran
    assert ft.dtype == lt.dtype == torch.float32
    ft, lt = ft.numpy(), lt.numpy()
    rowmax = np.abs(fj).max(-1, keepdims=True)
    assert np.max(np.abs(ft - fj) / rowmax) <= bar
    assert np.max(np.abs(lt - lj) / np.maximum(1.0, np.abs(lj))) <= bar
    if R == 4:
        # lane 1's last segment is all padding: skipped exactly, so the
        # walk returns its initial message and no scale
        np.testing.assert_array_equal(ft[3, 1], finit[3, 1])
        assert np.all(lt[3, 1] == 0.0)


def test_k2_wrapper_checks_and_devices():
    w = torch.rand(2, 8, 3)
    col = torch.rand(2, 3)
    finit = torch.rand(2, 2, 3, 3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k2.fb_fwd_product_sb(w.to("meta"), col.to("meta"),
                             finit.to("meta"), 0.9)
    with pytest.raises(ValueError, match="divide"):
        k2.fb_fwd_product_sb(w, col, torch.rand(3, 2, 3, 3), 0.9)
    S = k2.S_MAX + 1
    with pytest.raises(ValueError, match="speakers"):
        k2.fb_fwd_product_sb(torch.rand(1, 2, S), torch.rand(1, S),
                             torch.rand(1, 1, S, S), 0.9)


# ---- 2. the segment-count rule -------------------------------------------

def test_auto_segments_matches_vbx_tpu():
    for Tb in (12, 128, 256, 1000, 4096, 8192, 32768):
        for S in (1, 5, 8, 31, 128):
            for B in (1, 2, 4, 16):
                assert _auto_segments(Tb, S, B) == j_auto_segments(Tb, S, B)


# ---- 3. the structured blockwise smoother --------------------------------

def _jax_blockwise(log_p, pi, loop_prob, frame_mask, n_sp):
    mesh = jpar.make_mesh(n_dp=1, n_sp=n_sp)

    def fn(lp, fm):
        r = jpar.forward_backward_blockwise(lp, jnp.asarray(pi), loop_prob,
                                            frame_mask=fm, axis_name="sp")
        return r.gamma, r.log_px, r.pi_stat, r.gamma0

    sh = jax.shard_map(fn, mesh=mesh, in_specs=(P("sp", None), P("sp")),
                       out_specs=(P("sp", None), P(), P(), P()),
                       check_vma=False)
    return [np.asarray(x) for x in
            jax.jit(sh)(jnp.asarray(log_p), jnp.asarray(frame_mask))]


def _torch_blockwise(log_p, pi, loop_prob, frame_mask, n_sp):
    mesh = _cpu_mesh(1, n_sp)
    lp = torch.from_numpy(log_p)[None].chunk(n_sp, 1)
    fm = torch.from_numpy(frame_mask)[None].chunk(n_sp, 1)
    res = tpar.forward_backward_blockwise(
        list(lp), [torch.from_numpy(pi)[None]] * n_sp, loop_prob, mesh,
        frame_mask=list(fm))
    for r in res[1:]:                   # psum'd outputs are replicated
        for a, b in zip(r[1:], res[0][1:]):
            assert torch.equal(a, b)
    return [torch.cat([r.gamma for r in res], 1)[0].numpy(),
            float(res[0].log_px[0]), res[0].pi_stat[0].numpy(),
            res[0].gamma0[0].numpy()]


@pytest.mark.parametrize("n_sp", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_blockwise_matches_vbx_tpu(n_sp, dtype):
    """tests/test_parallel.py's bars against the sequential smoother:
    gamma and gamma0 1e-9 (f64) / 2e-5 (f32), log_px 10x that relative,
    pi_stat 1e-6 / 1e-3 relative."""
    rng = np.random.default_rng(n_sp)
    T, S = 192, 7
    log_p, pi, loop_prob = random_hmm_problem(rng, T, S)
    log_p, pi = log_p.astype(dtype), pi.astype(dtype)
    mask = np.ones(T, bool)
    j = _jax_blockwise(log_p, pi, loop_prob, mask, n_sp)
    t = _torch_blockwise(log_p, pi, loop_prob, mask, n_sp)
    tol = 1e-9 if dtype == "float64" else 2e-5
    np.testing.assert_allclose(t[0], j[0], atol=tol)
    np.testing.assert_allclose(t[1], float(j[1]), rtol=10 * tol)
    np.testing.assert_allclose(t[2], j[2],
                               rtol=1e-6 if dtype == "float64" else 1e-3,
                               atol=tol * float(np.max(j[2])))
    np.testing.assert_allclose(t[3], j[3], atol=tol)


def test_blockwise_padding_suffix_matches_vbx_tpu():
    """A padded suffix spanning shard boundaries: padded frames zero,
    gamma 1e-9, log_px 1e-10 and pi_stat 1e-8 relative (float64,
    tests/test_parallel.py's bars)."""
    rng = np.random.default_rng(9)
    T, S, pad = 150, 5, 42
    log_p, pi, loop_prob = random_hmm_problem(rng, T + pad, S)
    mask = np.arange(T + pad) < T
    j = _jax_blockwise(log_p, pi, loop_prob, mask, 4)
    t = _torch_blockwise(log_p, pi, loop_prob, mask, 4)
    np.testing.assert_allclose(t[0], j[0], atol=1e-9)
    assert np.all(t[0][T:] == 0)
    np.testing.assert_allclose(t[1], float(j[1]), rtol=1e-10)
    np.testing.assert_allclose(t[2], j[2], rtol=1e-8)


# ---- 4. the kernel blockwise smoother ------------------------------------

def _kernel_problem(T, S, B, seed):
    rng = np.random.default_rng(seed)
    logps, pis = [], []
    for _ in range(B):
        lp, pi, loop_prob = random_hmm_problem(rng, T, S)
        logps.append(lp.astype(np.float32))
        pis.append(pi.astype(np.float32))
    return np.stack(logps), np.stack(pis), loop_prob       # [B, T, S]


def _jax_blockwise_kernel(log_p, pi, loop_prob, mask, n_sp, eps=1e-8,
                          n_segments=None):
    mesh = jpar.make_mesh(n_dp=1, n_sp=n_sp)

    def fn(lp, fm):
        r = jpar.forward_backward_blockwise_pallas(
            lp, jnp.asarray(pi), loop_prob, eps=eps, frame_mask=fm,
            axis_name="sp", interpret=True, n_segments=n_segments,
            layout="bts")
        return r.gamma, r.log_px, r.pi_stat, r.gamma0

    sh = jax.shard_map(
        fn, mesh=mesh, in_specs=(P(None, "sp", None), P("sp", None)),
        out_specs=(P("sp", None, None), P(), P(), P()), check_vma=False)
    return [np.asarray(x) for x in
            jax.jit(sh)(jnp.asarray(log_p), jnp.asarray(mask))]


def _torch_blockwise_kernel(log_p, pi, loop_prob, mask, n_sp, eps=1e-8,
                            n_segments=None):
    mesh = _cpu_mesh(1, n_sp)
    res = tpar.forward_backward_blockwise_kernel(
        list(torch.from_numpy(log_p).chunk(n_sp, 1)),
        [torch.from_numpy(pi)] * n_sp, loop_prob, mesh, eps=eps,
        frame_mask=list(torch.from_numpy(mask).chunk(n_sp, 0)),
        n_segments=n_segments)
    return [torch.cat([r.gamma for r in res], 0).numpy(),
            res[0].log_px.numpy(), res[0].pi_stat.numpy(),
            res[0].gamma0.numpy()]


@pytest.mark.parametrize("n_sp", [2, 4, 8])
@pytest.mark.parametrize("n_segments", [1, 2, 4])
def test_blockwise_kernel_matches_vbx_tpu_pallas(n_sp, n_segments):
    """The K2 + K1 smoother (plain twins) vs vbx_tpu's Pallas form
    (interpret mode, layout='bts'), batched lanes with per-lane padding
    suffixes: gamma 5e-5, log_px 1e-5 relative, pi_stat and gamma0 1e-4 of
    their max."""
    T, S, B = 192, 7, 3
    log_p, pi, loop_prob = _kernel_problem(T, S, B, seed=100 + n_sp)
    mask = np.ones((T, B), bool)
    mask[150:, 1] = False
    mask[40:, 2] = False      # whole dead segments and blocks on lane 2
    j = _jax_blockwise_kernel(log_p, pi, loop_prob, mask, n_sp,
                              n_segments=n_segments)
    t = _torch_blockwise_kernel(log_p, pi, loop_prob, mask, n_sp,
                                n_segments=n_segments)
    np.testing.assert_allclose(t[0], j[0], atol=5e-5)
    assert np.all(t[0][np.broadcast_to(~mask[:, None, :], t[0].shape)] == 0)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-5)
    np.testing.assert_allclose(t[2], j[2], atol=1e-4 * float(j[2].max()))
    np.testing.assert_allclose(t[3], j[3], atol=1e-4)


def test_blockwise_kernel_all_dead_block_is_identity():
    """tests/test_parallel.py's round-3 case: shards 5-7 hold only padding
    for lane 0, and their operators must be exact identities. eps=1e-3
    makes any leftover folded-in transition visible in log_px; the port
    must match vbx_tpu and the sequential smoother to 2e-6 relative."""
    T, S, B, n_sp = 256, 6, 2, 8
    log_p, pi, loop_prob = _kernel_problem(T, S, B, seed=7)
    Tv = 150
    mask = np.ones((T, B), bool)
    mask[Tv:, 0] = False
    eps = 1e-3
    j = _jax_blockwise_kernel(log_p, pi, loop_prob, mask, n_sp, eps=eps)
    t = _torch_blockwise_kernel(log_p, pi, loop_prob, mask, n_sp, eps=eps)
    ref = jseq(jnp.asarray(log_p[0, :Tv]), jnp.asarray(pi[0]), loop_prob,
               eps=eps)
    np.testing.assert_allclose(t[1][0], j[1][0], rtol=2e-6)
    np.testing.assert_allclose(t[1][0], float(ref.log_px), rtol=2e-6)


# ---- 5-7. the sharded engine ---------------------------------------------

def _vb_batch(seed=42, B=4, T=96, S=5, D=12):
    """tests/test_parallel.py's problem: one padded tail (lane 1) and one
    padded speaker (lane 2)."""
    rng = np.random.default_rng(seed)
    problems = [random_vb_problem(rng, T, S, D) for _ in range(B)]
    X = np.stack([p[0] for p in problems])
    G = np.stack([p[2] for p in problems])
    PI = np.stack([p[3] for p in problems])
    FM = np.ones((B, T), bool)
    SM = np.ones((B, S), bool)
    FM[1, 80:] = False
    X[1, 80:] = 0
    G[1, 80:] = 0
    SM[2, -1] = False
    G[2, :, -1] = 0
    G[2] /= G[2].sum(1, keepdims=True)
    PI[2, -1] = 0
    PI[2] /= PI[2].sum()
    return [X, problems[0][1], G, PI, FM, SM]


KW = dict(loop_prob=0.9, Fa=0.4, Fb=11.0, max_iters=10, epsilon=1e-6)


def _both_sharded(args, n_dp, n_sp, **kw):
    j = jpar.vbx_sharded(jpar.make_mesh(n_dp=n_dp, n_sp=n_sp),
                         *map(jnp.asarray, args), **kw)
    t = tpar.vbx_sharded(_cpu_mesh(n_dp, n_sp), *args, **kw)
    return j, t


@pytest.mark.parametrize("n_dp,n_sp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_vbx_sharded_structured_matches_vbx_tpu(n_dp, n_sp):
    """float64 structured sharded EM on every mesh shape of 8 devices:
    equal n_iters, gamma 1e-8, pi 1e-9, ELBO 1e-9 relative. B=4 pads to 8
    with replicas of recording 0 on the (8, 1) mesh."""
    args = _vb_batch()
    B = 4
    if n_dp == 8:
        args = [np.concatenate([a, np.repeat(a[:1], 4, 0)]) if a.ndim > 1
                else a for a in args]
    j, t = _both_sharded(args, n_dp, n_sp, **KW)
    assert t.gamma.dtype == torch.float64
    for i in range(B):
        assert int(t.n_iters[i]) == int(j.n_iters[i]), i
        np.testing.assert_allclose(t.gamma[i].numpy(), np.asarray(j.gamma[i]),
                                   atol=1e-8)
        np.testing.assert_allclose(t.pi[i].numpy(), np.asarray(j.pi[i]),
                                   atol=1e-9)
        n = int(j.n_iters[i])
        np.testing.assert_allclose(t.elbo[i, :n].numpy(),
                                   np.asarray(j.elbo[i, :n]), rtol=1e-9)


@pytest.mark.parametrize("n_dp,n_sp", [(4, 2), (1, 8)])
@pytest.mark.parametrize("fb_impl", ["pallas", "pallas_bf16"])
def test_vbx_sharded_kernel_route_matches_vbx_tpu(n_dp, n_sp, fb_impl):
    """The kernel route (K2 and K1 twins) vs vbx_tpu's Pallas route in
    interpret mode, tests/test_parallel.py's bars: gamma and pi 5e-4
    (f32) / 5e-2 (bf16), equal n_iters (f32) or within one (bf16: the
    converged Delta-ELBO sits within an ulp of epsilon), ELBO 1e-5 / 2e-3
    relative.

    epsilon is 1e-3 here, above the float32 quantum of these ELBOs
    (|ELBO| ~ 1e3, one ulp 6e-5 to 1.2e-4). At 1e-6 the stop fires on
    whether a converged Delta-ELBO rounds to 0 or to +1 ulp, which two
    correct float32 implementations decide differently (measured at
    (1, 8): 7 iterations here, 6 in vbx_tpu, on lanes whose last deltas
    were 1.2e-4 and 0)."""
    args = _vb_batch()
    j, t = _both_sharded(args, n_dp, n_sp, fb_impl=fb_impl,
                         **dict(KW, epsilon=1e-3))
    assert t.gamma.dtype == torch.float32
    tol = 5e-4 if fb_impl == "pallas" else 5e-2
    for i in range(4):
        d = abs(int(t.n_iters[i]) - int(j.n_iters[i]))
        assert d <= (0 if fb_impl == "pallas" else 1), i
        np.testing.assert_allclose(t.gamma[i].numpy(), np.asarray(j.gamma[i]),
                                   atol=tol)
        np.testing.assert_allclose(t.pi[i].numpy(), np.asarray(j.pi[i]),
                                   atol=tol)
        n = min(int(j.n_iters[i]), int(t.n_iters[i]))
        np.testing.assert_allclose(
            t.elbo[i, :n].numpy(), np.asarray(j.elbo[i, :n]),
            rtol=1e-5 if fb_impl == "pallas" else 2e-3)


def test_vbx_sharded_past_k2_cap_warns_and_runs_structured():
    """S above K2's 128 speakers: on the CPU the kernel route warns and
    runs the structured sharded engine (its gamma equals that run's), as
    vbx_tpu does; and it agrees with vbx_tpu's structured sharded run
    (float32, 2e-5: tests/test_parallel.py's float32 blockwise bar)."""
    B, T, S, D = 2, 32, 130, 8
    rng = np.random.default_rng(7)
    args = [rng.normal(size=(B, T, D)).astype(np.float32),
            (np.abs(rng.normal(size=D)) + 0.5).astype(np.float32),
            rng.dirichlet(np.ones(S), size=(B, T)).astype(np.float32),
            np.full((B, S), 1.0 / S, np.float32), np.ones((B, T), bool),
            np.ones((B, S), bool)]
    kw = dict(loop_prob=0.9, Fa=0.4, Fb=11.0, max_iters=3, epsilon=1e-6)
    mesh = _cpu_mesh(2, 4)
    with pytest.warns(UserWarning, match="128 speakers"):
        res = tpar.vbx_sharded(mesh, *args, fb_impl="pallas", **kw)
    ref = tpar.vbx_sharded(mesh, *args, **kw)
    assert torch.equal(res.gamma, ref.gamma)
    j = jpar.vbx_sharded(jpar.make_mesh(2, 4), *map(jnp.asarray, args), **kw)
    np.testing.assert_allclose(res.gamma.numpy(), np.asarray(j.gamma),
                               atol=2e-5)


def test_vbx_sharded_resume_and_shape_checks():
    """converged0 / last_elbo0 / plateau0 resume as vbx_tpu's: a lane that
    starts converged stays frozen (0 iterations, NaN ELBO trace); and B
    and T must divide by the mesh extents."""
    args = _vb_batch()
    conv0 = np.array([False, True, False, False])
    le0 = np.array([-1e30, -1e3, -1e30, -1e30])     # NEG_INF = fresh
    kw = dict(KW, converged0=conv0, last_elbo0=le0,
              plateau0=np.zeros(4, np.int32))
    j, t = _both_sharded(args, 2, 4, **kw)
    np.testing.assert_array_equal(t.n_iters.numpy(), np.asarray(j.n_iters))
    assert int(t.n_iters[1]) == 0 and torch.isnan(t.elbo[1]).all()
    np.testing.assert_allclose(t.gamma.numpy(), np.asarray(j.gamma),
                               atol=1e-8)
    with pytest.raises(ValueError, match="T % n_sp"):
        tpar.vbx_sharded(_cpu_mesh(1, 5), *args, **KW)


# ---- 8. pipeline and CLI -------------------------------------------------

LENGTHS = [150, 600, 320, 450, 230]
SPEAKERS = [2, 5, 3, 4, 3]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("corpus")), 0, LENGTHS,
                        SPEAKERS)


def _same_rttms(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b))
    assert len(names) == len(LENGTHS)
    for f in names:
        assert filecmp.cmp(os.path.join(dir_a, f), os.path.join(dir_b, f),
                           shallow=False), f


def _cli_args(corpus, out_dir, *extra):
    return ["--init", "AHC+VB", "--out-rttm-dir", str(out_dir),
            "--xvec-ark-file", corpus["ark"], "--segments-file",
            corpus["segments"], "--xvec-transform", corpus["transform"],
            "--plda-file", corpus["plda"], "--device", "cpu", *extra]


def test_diarize_ark_on_a_mesh_matches_solo(corpus, tmp_path):
    """A 2x2 CPU mesh (structured sharded engine) writes the same RTTMs as
    the solo batched structured run, and as vbx_tpu's 2x2 mesh run."""
    from vbx_tpu.config import get_preset as jpreset
    from vbx_tpu.engine.pipeline import diarize_ark as jdiarize

    files = (corpus["ark"], corpus["segments"])
    models = (corpus["plda"], corpus["transform"])
    tpipe.diarize_ark(*files, str(tmp_path / "solo"), get_preset("example"),
                      *models, verbose=False, device="cpu")
    tpipe.diarize_ark(*files, str(tmp_path / "mesh"), get_preset("example"),
                      *models, verbose=False, device="cpu",
                      mesh=_cpu_mesh(2, 2))
    _same_rttms(tmp_path / "solo", tmp_path / "mesh")
    jdiarize(*files, str(tmp_path / "jax"), jpreset("example"), *models,
             verbose=False, mesh=jpar.make_mesh(2, 2))
    _same_rttms(tmp_path / "mesh", tmp_path / "jax")


def test_mesh_overrides_warn_and_sp_must_divide_the_bucket(corpus, tmp_path):
    cfg = get_preset("example")
    cfg = cfg.replace(vb=dataclasses.replace(cfg.vb, max_iters=2))
    files = (corpus["ark"], corpus["segments"], str(tmp_path / "a"), cfg,
             corpus["plda"], corpus["transform"])
    with pytest.warns(UserWarning, match="mesh routing overrides"):
        tpipe.diarize_ark(*files, verbose=False, device="cpu", batch=False,
                          mesh=_cpu_mesh(1, 2))
    with pytest.raises(ValueError, match="smallest frame bucket"):
        tpipe.diarize_ark(*files, verbose=False, device="cpu",
                          mesh=_cpu_mesh(1, 3))


def test_cli_mesh_matches_solo_and_rejects_bad_specs(corpus, tmp_path):
    assert torch_cli(_cli_args(corpus, tmp_path / "solo")) == 0
    assert torch_cli(_cli_args(corpus, tmp_path / "mesh",
                               "--mesh", "2x2")) == 0
    _same_rttms(tmp_path / "solo", tmp_path / "mesh")
    with pytest.raises(SystemExit, match="--mesh"):
        torch_cli(_cli_args(corpus, tmp_path / "bad", "--mesh", "4by2"))


# ---- 9. make_mesh --------------------------------------------------------

def test_make_mesh_devices_and_errors():
    m = tpar.make_mesh(2, 4, device="cpu")
    assert m.shape == {"dp": 2, "sp": 4}
    assert m.shape == dict(jpar.make_mesh(2, 4).shape)
    assert all(d == torch.device("cpu") for row in m.devices for d in row)
    assert tpar.make_mesh(n_sp=2, device="cpu").shape == {"dp": 1, "sp": 2}
    rep = tpar.make_mesh(1, 4, devices=["cpu"] * 4)     # a repeated device
    assert rep.shape == {"dp": 1, "sp": 4}
    assert rep.first_device == torch.device("cpu")
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        tpar.make_mesh(2, 4, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 2 devices, have 0"):
            tpar.make_mesh(1, 2)                     # device='cuda' default
    # the collectives: psum adds the shards, all_gather stacks them
    xs = [torch.full((2,), float(k)) for k in range(4)]
    assert all(torch.equal(s, torch.full((2,), 6.0)) for s in rep.psum(xs))
    assert all(torch.equal(g, torch.stack(xs)) for g in rep.all_gather(xs))
    with pytest.raises(ValueError, match="one tensor per shard"):
        rep.psum(xs[:3])


# ---- 10. the multi-device dryrun -------------------------------------------

@pytest.mark.parametrize("n,mesh_shape", [(4, {"dp": 2, "sp": 2}),
                                          (8, {"dp": 4, "sp": 2}),
                                          (3, {"dp": 3, "sp": 1})])
def test_dryrun_multichip_holds_its_four_checks_on_cpu_copies(n, mesh_shape):
    """vbx_tpu's __graft_entry__ dryrun on n CPU copies: the structured and
    kernel routes (the twins here), the two-slice checkpointed run equal to
    the one-shot run, and the mesh service equal to the solo service."""
    from vbx_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(n, device="cpu")
    assert out == {"mesh": mesh_shape, "devices": ["cpu"] * n,
                   "checks": ["structured", "kernel+plateau",
                              "checkpointed", "serving"]}


def test_dryrun_multichip_takes_a_device_list_and_needs_enough():
    from vbx_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(2, devices=["cpu", "cpu", "cpu"])
    assert out["mesh"] == {"dp": 1, "sp": 2} and len(out["devices"]) == 2
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        dryrun_multichip(2, devices=["cpu"])
