"""The port's dense and associative-scan smoothers
(vbx_tpu_torch.ops.forward_backward) and the engine's fb_impl='assoc'
route, against vbx_tpu's on the same numpy inputs.

Tolerances. float64: 1e-10 (the same arithmetic; only the summation order
inside logsumexp and the matvec differs, and the scan's combine tree is
vbx_tpu's odd/even scheme). float32: gamma 2e-5 for the sequential dense
smoother; the assoc smoother carries rounding through its log2(T)
composition rounds, so its float32 gamma is held at 2e-4 to vbx_tpu's
float32 run and, at long T, at tests/test_forward_backward.py's 2e-3 to
the float64 oracle. Padding is exact: a padded run restricted to its valid
prefix equals the unpadded run at 1e-12 in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbx_tpu.engine import vbhmm as jvb
from vbx_tpu.ops import forward_backward as jfb
from vbx_tpu_torch.engine import vbhmm as tvb
from vbx_tpu_torch.ops import forward_backward as tfb
from vbx_tpu_torch.testing import host_threads

from .oracle import (forward_backward_oracle, random_hmm_problem,
                     random_vb_problem, structured_transition)


# several test workers share the host: keep this file's pools to one thread
@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    with host_threads(1):
        yield


# jitted: run eagerly, vbx_tpu's associative_scan compiles every one of its
# slices and combines on its own, ten times the wall time of one program
_jax_assoc = jax.jit(jfb.forward_backward_assoc)


def _hold(t, j, gtol, ltol, ptol, stol=None):
    np.testing.assert_allclose(t.gamma.numpy(), np.asarray(j.gamma),
                               atol=gtol)
    np.testing.assert_allclose(float(t.log_px), float(j.log_px), rtol=ltol)
    pj = np.asarray(j.pi_stat)
    np.testing.assert_allclose(t.pi_stat.numpy(), pj,
                               atol=ptol * max(float(pj.max()), 1.0))
    if stol is not None:
        np.testing.assert_allclose(t.lfw.numpy(), np.asarray(j.lfw),
                                   atol=stol)
        np.testing.assert_allclose(t.lbw.numpy(), np.asarray(j.lbw),
                                   atol=stol)


@pytest.mark.parametrize("T,S", [(1, 3), (2, 2), (17, 5), (301, 12)])
def test_assoc_matches_jax_and_oracle_f64(T, S):
    rng = np.random.default_rng(T * 31 + S)
    log_p, pi, loop_prob = random_hmm_problem(rng, T, S)
    j = _jax_assoc(jnp.asarray(log_p), jnp.asarray(pi), loop_prob)
    t = tfb.forward_backward_assoc(torch.from_numpy(log_p),
                                   torch.from_numpy(pi), loop_prob)
    assert t.gamma.dtype == torch.float64 and t.gamma.shape == (T, S)
    _hold(t, j, 1e-10, 1e-10, 1e-10, stol=1e-8)
    g_ref, log_px_ref, lfw_ref, lbw_ref, pi_stat_ref = \
        forward_backward_oracle(log_p, structured_transition(pi, loop_prob),
                                pi)
    np.testing.assert_allclose(t.gamma.numpy(), g_ref, atol=1e-8)
    np.testing.assert_allclose(float(t.log_px), log_px_ref, rtol=1e-10)
    np.testing.assert_allclose(t.lfw.numpy(), lfw_ref, atol=1e-7)
    np.testing.assert_allclose(t.lbw.numpy(), lbw_ref, atol=1e-7)
    np.testing.assert_allclose(t.pi_stat.numpy(), pi_stat_ref, rtol=1e-7,
                               atol=1e-8)


@pytest.mark.parametrize("T,S", [(3, 2), (64, 7)])
def test_dense_matches_jax_and_oracle_f64(T, S):
    rng = np.random.default_rng(T * 100 + S)
    log_p, _, _ = random_hmm_problem(rng, T, S)
    tr = rng.dirichlet(np.ones(S), size=S)      # arbitrary stochastic matrix
    ip = rng.dirichlet(np.ones(S))
    j = jfb.forward_backward_dense(jnp.asarray(log_p), jnp.asarray(tr),
                                   jnp.asarray(ip))
    t = tfb.forward_backward_dense(torch.from_numpy(log_p),
                                   torch.from_numpy(tr), torch.from_numpy(ip))
    _hold(t, j, 1e-10, 1e-10, 1e-10, stol=1e-8)
    g_ref, log_px_ref, _, _, pi_stat_ref = forward_backward_oracle(
        log_p, tr, ip)
    np.testing.assert_allclose(t.gamma.numpy(), g_ref, atol=1e-8)
    np.testing.assert_allclose(float(t.log_px), log_px_ref, rtol=1e-10)
    np.testing.assert_allclose(t.pi_stat.numpy(), pi_stat_ref, rtol=1e-7)


def test_dense_with_the_structured_transition_equals_structured():
    """The dense smoother is the structured one's parity oracle: with
    tr = loopP*I + (1-loopP)*1 pi^T both give the same float64 result."""
    rng = np.random.default_rng(5)
    log_p, pi, loop_prob = random_hmm_problem(rng, 120, 6)
    tr = structured_transition(pi, loop_prob)
    d = tfb.forward_backward_dense(torch.from_numpy(log_p),
                                   torch.from_numpy(tr), torch.from_numpy(pi))
    s = tfb.forward_backward_structured(torch.from_numpy(log_p),
                                        torch.from_numpy(pi), loop_prob)
    _hold(d, s, 1e-10, 1e-10, 1e-10)


@pytest.mark.parametrize("impl,gtol", [("dense", 2e-5), ("assoc", 2e-4)])
def test_f32_matches_jax(impl, gtol):
    rng = np.random.default_rng(21)
    T, S = 200, 9
    log_p, pi, loop_prob = random_hmm_problem(rng, T, S)
    lp32, pi32 = log_p.astype(np.float32), pi.astype(np.float32)
    if impl == "dense":
        tr = structured_transition(pi, loop_prob).astype(np.float32)
        j = jfb.forward_backward_dense(jnp.asarray(lp32), jnp.asarray(tr),
                                       jnp.asarray(pi32))
        t = tfb.forward_backward_dense(torch.from_numpy(lp32),
                                       torch.from_numpy(tr),
                                       torch.from_numpy(pi32))
    else:
        j = _jax_assoc(jnp.asarray(lp32), jnp.asarray(pi32), loop_prob)
        t = tfb.forward_backward_assoc(torch.from_numpy(lp32),
                                       torch.from_numpy(pi32), loop_prob)
    assert t.gamma.dtype == torch.float32
    _hold(t, j, gtol, 1e-5, 10 * gtol)


def test_assoc_f32_stays_exact_at_long_T():
    """tests/test_forward_backward.py's long-T case for the assoc form:
    float32 at T=1500, S=23, |log_px| > 3e4, against the float64 oracle at
    that test's bars (gamma 2e-3, log_px 1e-5, pi_stat 2e-3 x max)."""
    rng = np.random.default_rng(7)
    T, S = 1500, 23
    log_p, pi, loop_prob = random_hmm_problem(rng, T, S, scale=5.0)
    g_ref, log_px_ref, _, _, pi_stat_ref = forward_backward_oracle(
        log_p, structured_transition(pi, loop_prob), pi)
    assert abs(float(log_px_ref)) > 3e4
    t = tfb.forward_backward_assoc(
        torch.from_numpy(log_p.astype(np.float32)),
        torch.from_numpy(pi.astype(np.float32)), loop_prob)
    np.testing.assert_allclose(t.gamma.numpy(), g_ref, atol=2e-3)
    np.testing.assert_allclose(float(t.log_px), log_px_ref, rtol=1e-5)
    np.testing.assert_allclose(t.pi_stat.numpy(), pi_stat_ref,
                               atol=2e-3 * pi_stat_ref.max())


@pytest.mark.parametrize("impl", ["dense", "assoc"])
def test_padding_is_exact(impl):
    rng = np.random.default_rng(3)
    T, S, pad = 97, 6, 31
    log_p, pi, loop_prob = random_hmm_problem(rng, T + pad, S)
    mask = torch.from_numpy(np.arange(T + pad) < T)
    lp, p = torch.from_numpy(log_p), torch.from_numpy(pi)
    if impl == "dense":
        tr = torch.from_numpy(structured_transition(pi, loop_prob))
        full = tfb.forward_backward_dense(lp[:T], tr, p)
        padded = tfb.forward_backward_dense(lp, tr, p, frame_mask=mask)
    else:
        full = tfb.forward_backward_assoc(lp[:T], p, loop_prob)
        padded = tfb.forward_backward_assoc(lp, p, loop_prob,
                                            frame_mask=mask)
    np.testing.assert_allclose(padded.gamma[:T].numpy(), full.gamma.numpy(),
                               atol=1e-12)
    assert torch.all(padded.gamma[T:] == 0.0)
    np.testing.assert_allclose(float(padded.log_px), float(full.log_px),
                               rtol=1e-12)
    np.testing.assert_allclose(padded.pi_stat.numpy(), full.pi_stat.numpy(),
                               rtol=1e-10)


def test_batched_smoothers_equal_their_single_runs():
    """[B, T, S] inputs (the engine's form): each lane equals its own
    [T, S] run, with a padded suffix on lane 1."""
    rng = np.random.default_rng(8)
    B, T, S = 3, 40, 4
    probs = [random_hmm_problem(rng, T, S) for _ in range(B)]
    log_p = torch.from_numpy(np.stack([p[0] for p in probs]))
    pi = torch.from_numpy(np.stack([p[1] for p in probs]))
    mask = torch.ones((B, T), dtype=torch.bool)
    mask[1, 30:] = False
    tr = torch.from_numpy(np.stack(
        [structured_transition(p[1], 0.9) for p in probs]))
    ba = tfb.forward_backward_assoc(log_p, pi, 0.9, frame_mask=mask)
    bd = tfb.forward_backward_dense(log_p, tr, pi, frame_mask=mask)
    for b in range(B):
        sa = tfb.forward_backward_assoc(log_p[b], pi[b], 0.9,
                                        frame_mask=mask[b])
        sd = tfb.forward_backward_dense(log_p[b], tr[b], pi[b],
                                        frame_mask=mask[b])
        for batched, single in ((ba, sa), (bd, sd)):
            np.testing.assert_allclose(batched.gamma[b].numpy(),
                                       single.gamma.numpy(), atol=1e-12)
            np.testing.assert_allclose(float(batched.log_px[b]),
                                       float(single.log_px), rtol=1e-12)
            np.testing.assert_allclose(batched.pi_stat[b].numpy(),
                                       single.pi_stat.numpy(), rtol=1e-10)


def test_associative_scan_keeps_operand_order():
    """The scan's operator need not commute: prefix and (operand-swapped)
    suffix products of random 2x2 matrices equal the sequential products,
    for even and odd lengths."""
    rng = np.random.default_rng(1)

    def matmul(a, b):
        return (torch.matmul(a[0], b[0]),)

    for n in (1, 2, 5, 8, 13):
        mats = torch.from_numpy(rng.standard_normal((n, 2, 2)))
        (pre,) = tfb._associative_scan(matmul, (mats,))
        (suf,) = tfb._associative_scan(lambda x, y: matmul(y, x), (mats,),
                                       reverse=True)
        acc = torch.eye(2, dtype=torch.float64)
        for i in range(n):
            acc = acc @ mats[i]
            torch.testing.assert_close(pre[i], acc, rtol=1e-10, atol=1e-12)
        acc = torch.eye(2, dtype=torch.float64)
        for i in range(n - 1, -1, -1):
            acc = mats[i] @ acc
            torch.testing.assert_close(suf[i], acc, rtol=1e-10, atol=1e-12)


def test_vbx_assoc_matches_jax_engine_f64():
    """vbx(fb_impl='assoc') in float64: the ELBO trace within 1e-9 relative
    of vbx_tpu's assoc engine and the same iteration count."""
    rng = np.random.default_rng(3)
    X, phi, gamma, pi = random_vb_problem(rng, 120, 6, 16)
    kw = dict(loop_prob=0.9, Fa=0.4, Fb=11.0, max_iters=25, epsilon=1e-6,
              fb_impl="assoc")
    j = jvb.vbx(jnp.asarray(X), jnp.asarray(phi), pi=jnp.asarray(pi),
                gamma=jnp.asarray(gamma), **kw)
    t = tvb.vbx(X, phi, pi=pi, gamma=gamma, device="cpu", **kw)
    n = int(t.n_iters)
    assert n == int(j.n_iters)
    np.testing.assert_allclose(t.elbo.numpy()[:n], np.asarray(j.elbo)[:n],
                               rtol=1e-9)
    np.testing.assert_allclose(t.gamma.numpy(), np.asarray(j.gamma),
                               atol=1e-8)
    s = tvb.vbx(X, phi, pi=pi, gamma=gamma, device="cpu",
                **dict(kw, fb_impl="structured"))
    np.testing.assert_allclose(t.elbo.numpy()[:n], s.elbo.numpy()[:n],
                               rtol=1e-9)


def test_vbx_batched_assoc_matches_jax_engine_f64():
    rng = np.random.default_rng(6)
    B, T, S, D = 3, 50, 4, 8
    problems = [random_vb_problem(rng, T, S, D) for _ in range(B)]
    phi = problems[0][1]
    X = np.stack([p[0] for p in problems])
    G = np.stack([p[2] for p in problems])
    PI = np.stack([p[3] for p in problems])
    FM = np.ones((B, T), bool)
    FM[1, 35:] = False
    X[1, 35:] = 0
    G[1, 35:] = 0
    SM = np.ones((B, S), bool)
    kw = dict(loop_prob=0.9, Fa=0.4, Fb=11.0, max_iters=12, epsilon=1e-6,
              fb_impl="assoc")
    j = jvb.vbx_batched(jnp.asarray(X), jnp.asarray(phi), jnp.asarray(G),
                        jnp.asarray(PI), jnp.asarray(FM), jnp.asarray(SM),
                        **kw)
    t = tvb.vbx_batched(X, phi, G, PI, FM, SM, device="cpu", **kw)
    np.testing.assert_array_equal(t.n_iters.numpy(), np.asarray(j.n_iters))
    np.testing.assert_allclose(t.elbo.numpy(), np.asarray(j.elbo), rtol=1e-9)
    np.testing.assert_allclose(t.gamma.numpy(), np.asarray(j.gamma),
                               atol=1e-8)


def test_unknown_fb_impl_still_raises():
    X = np.zeros((1, 4, 3))
    g = np.full((1, 4, 2), 0.5)
    args = (X, np.ones(3), g, np.full((1, 2), 0.5), np.ones((1, 4), bool),
            np.ones((1, 2), bool), 0.9, 0.3, 17.0)
    with pytest.raises(ValueError, match="unknown fb_impl='dense'"):
        tvb.vbx_batched(*args, fb_impl="dense", device="cpu")
    with pytest.raises(ValueError, match="batched-only"):
        tvb.vbx(X[0], np.ones(3), gamma=g[0], pi=2, fb_impl="pallas",
                device="cpu")
