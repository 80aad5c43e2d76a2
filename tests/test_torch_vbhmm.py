"""The port's VB-HMM engine (vbx_tpu_torch.engine.vbhmm) against the float64
oracle and against vbx_tpu's engines, on the same numpy inputs. Runs on the
CPU: the kernel route uses the fused kernel's plain twin there, and JAX's
'pallas' engine runs its kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbx_tpu.engine import vbhmm as jvb
from vbx_tpu_torch.engine import vbhmm as tvb
from vbx_tpu_torch.testing import host_threads

from .oracle import random_vb_problem, vbx_oracle


# several test workers share the host: keep this file's pools to one thread
@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    with host_threads(1):
        yield

KW = dict(loop_prob=0.9, Fa=0.4, Fb=11.0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("with_model", [False, True])
def test_vbx_f64_matches_oracle_and_jax(with_model):
    """Float64 single-recording EM: ELBO trace within 1e-10 relative of the
    oracle and of vbx_tpu (both float64; only summation order differs) and
    the same iteration count; with an initial speaker model, iteration 0
    skips the M-step (VBx.py:94)."""
    rng = np.random.default_rng(4)
    X, phi, gamma, pi = random_vb_problem(rng, 200, 5, 16)
    kw = dict(KW, max_iters=25, epsilon=1e-6)
    model = {}
    if with_model:
        model = dict(alpha=rng.standard_normal((5, 16)),
                     invL=rng.uniform(0.1, 1.0, (5, 16)))
    _, _, o_elbo, _, _ = vbx_oracle(X, phi, pi=pi, gamma=gamma, **kw, **model)
    j = jvb.vbx(jnp.asarray(X), jnp.asarray(phi), pi=jnp.asarray(pi),
                gamma=jnp.asarray(gamma),
                **kw, **{k: jnp.asarray(v) for k, v in model.items()})
    t = tvb.vbx(X, phi, pi=pi, gamma=gamma, device="cpu", **kw, **model)
    n = int(t.n_iters)
    assert n == int(j.n_iters) == len(o_elbo)
    assert t.elbo.dtype == torch.float64
    np.testing.assert_allclose(_np(t.elbo)[:n], o_elbo, rtol=1e-10)
    np.testing.assert_allclose(_np(t.elbo)[:n], _np(j.elbo)[:n], rtol=1e-10)
    assert np.all(np.isnan(_np(t.elbo)[n:]))
    np.testing.assert_allclose(_np(t.gamma), _np(j.gamma), atol=1e-10)


def _padded_batch(B, T, S, D, seed):
    """Padded batch as in tests/test_pallas.py: lane 1 short, lane 2 with
    an absent last speaker."""
    rng = np.random.default_rng(seed)
    problems = [random_vb_problem(rng, T, S, D) for _ in range(B)]
    phi = problems[0][1]
    X = np.stack([p[0] for p in problems])
    G = np.stack([p[2] for p in problems])
    PI = np.stack([p[3] for p in problems])
    FM = np.ones((B, T), bool)
    SM = np.ones((B, S), bool)
    FM[1, T * 2 // 3:] = False
    X[1, T * 2 // 3:] = 0
    G[1, T * 2 // 3:] = 0
    SM[2, -1] = False
    G[2, :, -1] = 0
    G[2] /= G[2].sum(-1, keepdims=True)
    PI[2, -1] = 0
    PI[2] /= PI[2].sum()
    return X, phi, G, PI, FM, SM


def _run_both(args, dtype, jax_impl, torch_impl=None, **kw):
    X, phi, G, PI, FM, SM = args
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    ref = jvb.vbx_batched(jnp.asarray(X, jdt), jnp.asarray(phi, jdt),
                          jnp.asarray(G, jdt), jnp.asarray(PI, jdt),
                          jnp.asarray(FM), jnp.asarray(SM),
                          fb_impl=jax_impl, **kw)
    out = tvb.vbx_batched(X.astype(dtype), phi.astype(dtype),
                          G.astype(dtype), PI.astype(dtype), FM, SM,
                          fb_impl=torch_impl or jax_impl, device="cpu", **kw)
    return ref, out


# float64: only summation order differs, so the trace holds to 1e-10 and
# the epsilon rule fires on the same iteration. float32: roundoff of two
# implementations over 8 EM iterations; at |ELBO|~1e3 an f32 quantum
# (~1e-4) dwarfs epsilon=1e-6, so which iteration's delta first lands
# below it is roundoff, and the float32 case runs all 8 iterations
# (epsilon=-1) to compare whole trajectories.
@pytest.mark.parametrize("dtype,eps,etol,gtol",
                         [(np.float64, 1e-6, 1e-10, 1e-10),
                          (np.float32, -1.0, 1e-5, 1e-4)])
def test_vbx_batched_structured_matches_jax(dtype, eps, etol, gtol):
    args = _padded_batch(4, 60, 5, 12, seed=1)
    ref, out = _run_both(args, dtype, "structured",
                         max_iters=8, epsilon=eps, **KW)
    assert out.gamma.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    np.testing.assert_array_equal(_np(out.n_iters), _np(ref.n_iters))
    np.testing.assert_allclose(_np(out.elbo), _np(ref.elbo), rtol=etol)
    np.testing.assert_allclose(_np(out.gamma), _np(ref.gamma), atol=gtol)
    np.testing.assert_allclose(_np(out.pi), _np(ref.pi), atol=gtol)
    np.testing.assert_allclose(_np(out.alpha), _np(ref.alpha),
                               atol=gtol * 10, rtol=etol * 10)


def test_vbx_batched_kernel_route_matches_jax_pallas():
    """The kernel route (plain twin on the CPU) against vbx_tpu's 'pallas'
    engine (interpret mode) at tests/test_pallas.py's pallas-vs-structured
    bars: equal iteration counts, ELBO rtol 1e-4, gamma 5e-4, pi 1e-4."""
    args = _padded_batch(18, 50, 5, 8, seed=7)
    ref, out = _run_both(args, np.float32, "pallas",
                         max_iters=5, epsilon=1e-6, **KW)
    np.testing.assert_array_equal(_np(out.n_iters), _np(ref.n_iters))
    for b in range(18):
        n = int(ref.n_iters[b])
        np.testing.assert_allclose(_np(out.elbo[b])[:n],
                                   _np(ref.elbo[b])[:n], rtol=1e-4)
        np.testing.assert_allclose(_np(out.gamma[b]), _np(ref.gamma[b]),
                                   atol=5e-4)
        np.testing.assert_allclose(_np(out.pi[b]), _np(ref.pi[b]), atol=1e-4)


def test_vbx_batched_bf16_route_tracks_jax_bf16_at_fixed_point():
    """bfloat16 streams against vbx_tpu's 'pallas_bf16' at the fixed point,
    with tests/test_pallas.py:182-239's bars: converged ELBO within 1e-3,
    labels flip only on frames the reference rates soft (<= 2% of frames),
    posteriors mostly within 5e-2, pi within 2e-2 after label alignment."""
    from scipy.optimize import linear_sum_assignment

    X, phi, G, PI, FM, SM = _padded_batch(18, 50, 5, 8, seed=7)
    SM[:] = True
    G = np.stack([random_vb_problem(np.random.default_rng(7 + b), 50, 5,
                                    8)[2] for b in range(18)])
    G[1, 33:] = 0
    PI = np.full((18, 5), 0.2)
    ref, out = _run_both((X, phi, G, PI, FM, SM), np.float32, "pallas_bf16",
                         max_iters=40, epsilon=1e-6, **KW)
    assert out.gamma.dtype == torch.float32
    S = 5
    for b in range(18):
        n_ref, n_out = int(ref.n_iters[b]), int(out.n_iters[b])
        np.testing.assert_allclose(float(out.elbo[b][n_out - 1]),
                                   float(ref.elbo[b][n_ref - 1]), rtol=1e-3)
        tmask = FM[b]
        g_ref = _np(ref.gamma[b])[tmask]
        g_out = _np(out.gamma[b])[tmask]
        conf = (g_ref.argmax(-1)[:, None] == np.arange(S)[None]).T.astype(
            int) @ (g_out.argmax(-1)[:, None] == np.arange(S)[None]).astype(
            int)
        _, cc = linear_sum_assignment(-conf)
        g_out = g_out[:, cc]
        flipped = g_out.argmax(-1) != g_ref.argmax(-1)
        assert np.mean(flipped) <= 0.02
        assert np.all(g_ref[flipped].max(-1) < 0.9)
        assert np.mean(np.abs(g_out - g_ref) > 5e-2) < 0.05
        np.testing.assert_allclose(_np(out.pi[b])[cc], _np(ref.pi[b]),
                                   atol=2e-2)


def test_kernel_route_result_is_batch_independent():
    """A recording's kernel-route result does not depend on its batch
    beyond float rounding: same iteration count, gamma/pi within 5e-5
    (tests/test_pallas.py:242-275's bar)."""
    T, S, D = 60, 6, 10
    rng = np.random.default_rng(3)
    X1, phi, G1, PI1 = random_vb_problem(rng, T, S, D)
    kw = dict(KW, max_iters=6, epsilon=1e-6, fb_impl="pallas", device="cpu")

    def run(B, pos):
        fillers = [random_vb_problem(rng, T, S, D) for _ in range(B)]
        X = np.stack([f[0] for f in fillers]).astype(np.float32)
        G = np.stack([f[2] for f in fillers]).astype(np.float32)
        X[pos], G[pos] = X1, G1
        PI = np.broadcast_to(PI1, (B, S)).astype(np.float32)
        r = tvb.vbx_batched(X, phi.astype(np.float32), G, PI,
                            np.ones((B, T), bool), np.ones((B, S), bool),
                            **kw)
        return _np(r.gamma[pos]), _np(r.pi[pos]), int(r.n_iters[pos])

    g_solo, pi_solo, n_solo = run(1, 0)
    for B, pos in ((4, 2), (20, 19)):
        g, pi, n = run(B, pos)
        assert n == n_solo
        np.testing.assert_allclose(g, g_solo, atol=5e-5)
        np.testing.assert_allclose(pi, pi_solo, atol=5e-5)


@pytest.mark.parametrize("fb_impl", ["structured", "pallas"])
def test_convergence_check_interval_changes_nothing(monkeypatch, fb_impl):
    """Checking "all converged" every k iterations (one host sync per
    check) gives results identical to checking every iteration: frozen
    lanes keep their state and their ELBO columns stay NaN."""
    args = _padded_batch(4, 40, 4, 6, seed=2)
    X, phi, G, PI, FM, SM = (a.astype(np.float32) if a.dtype == np.float64
                             else a for a in args)
    kw = dict(KW, max_iters=30, epsilon=1e-3, fb_impl=fb_impl, device="cpu")
    runs = []
    for k in (1, 7):
        monkeypatch.setattr(tvb, "CHECK_EVERY", k)
        runs.append(tvb.vbx_batched(X, phi, G, PI, FM, SM, **kw))
    a, b = runs
    assert int(a.n_iters.max()) < 30          # converged before max_iters
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_np(x), _np(y))


def _one_recording(T, S, D, seed):
    rng = np.random.default_rng(seed)
    X, phi, gamma, pi = random_vb_problem(rng, T, S, D)
    return (X[None].astype(np.float32), phi.astype(np.float32),
            gamma[None].astype(np.float32), pi[None].astype(np.float32),
            np.ones((1, T), bool), np.ones((1, S), bool))


def test_s_over_kernel_capacity_warns_and_runs_structured():
    """Past the kernel's S_MAX speakers the kernel route falls back to the
    structured engine with a warning on the CPU, and the result equals the
    structured run; on a card the same request raises."""
    S = tvb.S_MAX + 1
    args = _one_recording(16, S, 4, seed=129)
    kw = dict(KW, max_iters=3, epsilon=1e-6, device="cpu")
    with pytest.warns(UserWarning, match=f"{tvb.S_MAX} speakers"):
        res = tvb.vbx_batched(*args, fb_impl="pallas", **kw)
    ref = tvb.vbx_batched(*args, fb_impl="structured", **kw)
    np.testing.assert_array_equal(_np(res.gamma), _np(ref.gamma))
    assert int(res.n_iters[0]) == int(ref.n_iters[0])
    with pytest.raises(ValueError, match="speakers"):
        tvb._over_kernel_capacity("pallas", S, torch.device("cuda"))


def test_kernel_route_runs_past_256_speakers():
    """S in (256, S_MAX] stays on the kernel route (vbx_tpu's kernel stopped
    at 256): at S=300 it tracks the float32 structured engine within
    tests/test_pallas.py's pallas-vs-structured bars."""
    args = _one_recording(40, 300, 6, seed=300)
    kw = dict(KW, max_iters=4, epsilon=-1.0, device="cpu")
    res = tvb.vbx_batched(*args, fb_impl="pallas", **kw)
    ref = tvb.vbx_batched(*args, fb_impl="structured", **kw)
    np.testing.assert_array_equal(_np(res.n_iters), _np(ref.n_iters))
    np.testing.assert_allclose(_np(res.elbo), _np(ref.elbo), rtol=1e-4)
    np.testing.assert_allclose(_np(res.gamma), _np(ref.gamma), atol=5e-4)
    np.testing.assert_allclose(_np(res.pi), _np(ref.pi), atol=1e-4)


def test_dirichlet_init_is_seeded():
    """gamma=None draws the flat-Dirichlet init from the caller's
    torch.Generator: the same seed gives the same run."""
    rng = np.random.default_rng(0)
    X, phi, _, _ = random_vb_problem(rng, 80, 4, 6)
    runs = [tvb.vbx(X, phi, pi=4, rng=torch.Generator().manual_seed(3),
                    max_iters=3, device="cpu") for _ in range(2)]
    np.testing.assert_array_equal(_np(runs[0].gamma), _np(runs[1].gamma))
    assert np.all(np.isfinite(_np(runs[0].elbo)[:int(runs[0].n_iters)]))
    with pytest.raises(ValueError, match="rng"):
        tvb.vbx(X, phi, pi=4, device="cpu")


def test_result_fields_match_jax():
    assert tvb.VBxResult._fields == jvb.VBxResult._fields
