"""The [T, B, S] smoother API of the port (vbx_tpu_torch.ops.fb_scan_kernel)
against vbx_tpu's fb_scan_pallas run in interpret mode, on the same inputs.

On the CPU each wrapper runs its kernel's plain twin; the CUDA kernels are
held against the twins by tests/test_torch_gpu.py and chip_smoke.py on a
card.

Tolerances. ahat and the per-frame-normalized bhat on valid frames: 1e-6
(the same float32 recursion in both packages; only the summation order of a
frame's S products differs). bhat is compared only after normalizing each
frame: vbx_tpu pads speakers to 128 lanes and fills invalid frames with
1/128, the port does not pad and uses 1/S, and bhat is defined up to a
per-frame scale. gamma 2e-5, log_px 1e-5 relative and pi_stat 2e-4 x max
against the structured smoother are tests/test_pallas.py's bars.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbx_tpu.ops.fb_pallas import fb_scan_pallas
from vbx_tpu_torch.ops import fb_scan_kernel as fbs
from vbx_tpu_torch.ops.forward_backward import forward_backward_structured
from vbx_tpu_torch.testing import host_threads

from .oracle import random_hmm_problem


# several test workers share the host: keep this file's pools to one thread
@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    with host_threads(1):
        yield


def _assemble(ahat, bhat, cfw, w, m, valid):
    """gamma / log_px / pi_stat from kernel outputs (tests/test_pallas.py)."""
    ab = ahat * bhat
    denom = np.maximum(ab.sum(-1, keepdims=True), 1e-37)
    gamma = ab / denom * valid[:, :, None]
    log_px = (valid * (m + np.log(cfw))).sum(0)
    nf = valid.copy()
    nf[0] = 0.0
    terms = w * bhat / (denom * cfw[:, :, None])
    pi_stat = (terms * nf[:, :, None]).sum(0)
    return gamma, log_px, pi_stat


def _norm(bhat):
    return bhat / bhat.sum(-1, keepdims=True)


def _problem(T, S, B, seed, short_lane=None):
    """w [T, B, S], m [T, B], col/pinit [B, S], valid [T, B] and the
    per-lane (log_p, pi) from random_hmm_problem; `short_lane` = (lane,
    valid length) pads that lane's suffix."""
    rng = np.random.default_rng(seed)
    loop_prob = 0.9
    w = np.zeros((T, B, S), np.float32)
    m = np.zeros((T, B), np.float32)
    col = np.zeros((B, S), np.float32)
    pinit = np.zeros((B, S), np.float32)
    valid = np.ones((T, B), np.float32)
    lanes = []
    for b in range(B):
        log_p, pi, _ = random_hmm_problem(rng, T, S)
        lp32 = log_p.astype(np.float32)
        m[:, b] = lp32.max(1)
        w[:, b] = np.exp(lp32 - m[:, b, None])
        col[b] = (1 - loop_prob) * pi + 1e-8
        pinit[b] = pi + 1e-8
        lanes.append((lp32, pi.astype(np.float32)))
    if short_lane is not None:
        valid[short_lane[1]:, short_lane[0]] = 0.0
    return w, m, col, pinit, valid, lanes, loop_prob


def _run_both(w, valid, col, pinit, loop_prob, fused):
    j = fb_scan_pallas(jnp.asarray(w), jnp.asarray(valid), jnp.asarray(col),
                       jnp.asarray(pinit), loop_prob, interpret=True,
                       fused=fused)
    t = fbs.fb_scan(torch.from_numpy(w), torch.from_numpy(valid),
                    torch.from_numpy(col), torch.from_numpy(pinit),
                    loop_prob, fused=fused)
    assert all(x.dtype == torch.float32 for x in t)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _hold_to_jax(j, t, valid):
    vm = valid.astype(bool)
    np.testing.assert_allclose(t[0][vm], j[0][vm], atol=1e-6)
    np.testing.assert_allclose(_norm(t[1])[vm], _norm(j[1])[vm], atol=1e-6)
    np.testing.assert_allclose(t[2][vm], j[2][vm], rtol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("T,S,B", [(40, 5, 3), (600, 31, 4)])
def test_fb_scan_matches_pallas_and_sequential(T, S, B, fused):
    """Lane 1 ends in a padded suffix of T // 5 frames."""
    w, m, col, pinit, valid, lanes, loop_prob = _problem(
        T, S, B, seed=T + S, short_lane=(1, T - T // 5))
    j, t = _run_both(w, valid, col, pinit, loop_prob, fused)
    _hold_to_jax(j, t, valid)
    gamma, log_px, pi_stat = _assemble(*t, w, m, valid)
    g_j, lpx_j, ps_j = _assemble(*j, w, m, valid)
    np.testing.assert_allclose(gamma, g_j, atol=2e-5)
    np.testing.assert_allclose(log_px, lpx_j, rtol=1e-5)
    for b, (lp32, pi) in enumerate(lanes):
        n = int(valid[:, b].sum())
        seq = forward_backward_structured(torch.from_numpy(lp32[:n]),
                                          torch.from_numpy(pi), loop_prob)
        np.testing.assert_allclose(gamma[:n, b], seq.gamma.numpy(),
                                   atol=2e-5)
        assert np.all(gamma[n:, b] == 0)
        np.testing.assert_allclose(log_px[b], float(seq.log_px), rtol=1e-5)
        np.testing.assert_allclose(
            pi_stat[b], seq.pi_stat.numpy(),
            atol=2e-4 * float(seq.pi_stat.max()))


@pytest.mark.parametrize("fused", [True, False])
def test_fb_scan_padding(fused):
    """tests/test_pallas.py's padded case: T=100 valid frames + 30 padded,
    S=6, B=1, against the structured smoother on the valid prefix."""
    T, pad, S = 100, 30, 6
    w, m, col, pinit, valid, lanes, loop_prob = _problem(
        T + pad, S, 1, seed=0, short_lane=(0, T))
    j, t = _run_both(w, valid, col, pinit, loop_prob, fused)
    _hold_to_jax(j, t, valid)
    gamma, log_px, pi_stat = _assemble(*t, w, m, valid)
    lp32, pi = lanes[0]
    seq = forward_backward_structured(torch.from_numpy(lp32[:T]),
                                      torch.from_numpy(pi), loop_prob)
    np.testing.assert_allclose(gamma[:T, 0], seq.gamma.numpy(), atol=2e-5)
    assert np.all(gamma[T:, 0] == 0)
    np.testing.assert_allclose(log_px[0], float(seq.log_px), rtol=1e-5)
    np.testing.assert_allclose(pi_stat[0], seq.pi_stat.numpy(), rtol=2e-3)
    # the backward carry stays uniform through the padded suffix
    np.testing.assert_allclose(t[1][T:, 0], 1.0 / S, rtol=1e-6)


@pytest.mark.parametrize("fused", [True, False])
def test_fb_scan_at_the_speaker_cap(fused):
    """S = 128, the API's cap (vbx_tpu's lane tile, no padded lanes there).
    Sums of 128 products in two orders: the 1e-6 bar still holds."""
    w, m, col, pinit, valid, _, loop_prob = _problem(
        50, fbs.S_MAX, 2, seed=9, short_lane=(1, 40))
    j, t = _run_both(w, valid, col, pinit, loop_prob, fused)
    _hold_to_jax(j, t, valid)


def test_fb_scan_past_the_cap_raises_like_fb_scan_pallas():
    S = fbs.S_MAX + 1
    w = np.ones((3, 2, S), np.float32)
    valid = np.ones((3, 2), np.float32)
    colp = np.ones((2, S), np.float32)
    with pytest.raises(ValueError) as j_err:
        fb_scan_pallas(jnp.asarray(w), jnp.asarray(valid), jnp.asarray(colp),
                       jnp.asarray(colp), 0.9, interpret=True)
    with pytest.raises(ValueError) as t_err:
        fbs.fb_scan(torch.from_numpy(w), torch.from_numpy(valid),
                    torch.from_numpy(colp), torch.from_numpy(colp), 0.9)
    assert str(t_err.value) == str(j_err.value) == \
        f"S={S} > 128 lanes; shard speakers first"
    for fn in (fbs.fb_scan_fused, fbs.fb_scan_fwd):
        with pytest.raises(ValueError, match="shard speakers first"):
            fn(torch.from_numpy(w), torch.from_numpy(colp),
               torch.from_numpy(colp), 0.9)


def test_fused_twin_equals_two_pass_twins():
    """The fused twin is the two chains of the two-pass twins, so on the
    CPU fb_scan(fused=True) and (fused=False) agree exactly on ahat and
    bhat, and cfw (rebuilt outside the fused kernel) to float32 roundoff."""
    w, _, col, pinit, valid, _, loop_prob = _problem(
        70, 7, 3, seed=4, short_lane=(2, 50))
    args = [torch.from_numpy(x) for x in (w, valid, col, pinit)]
    a1, b1, c1 = fbs.fb_scan(*args, loop_prob, fused=True)
    a2, b2, c2 = fbs.fb_scan(*args, loop_prob, fused=False)
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    torch.testing.assert_close(c1, c2, rtol=1e-6, atol=0)


def test_wrappers_run_twins_only_for_cpu_tensors():
    """CPU tensors take the plain twins without counting a launch; tensors
    on any other non-CUDA device are refused, never moved to the CPU."""
    T, B, S = 5, 2, 3
    w, col, pinit = torch.rand(T, B, S), torch.rand(B, S), torch.rand(B, S)
    calls = ((fbs.fb_scan_fused, (w, col, pinit)),
             (fbs.fb_scan_fwd, (w, col, pinit)),
             (fbs.fb_scan_bwd, (w, col)))
    for fn, args in calls:
        before = fn.launches
        fn(*args, 0.9)
        assert fn.launches == before
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(*(a.to("meta") for a in args), 0.9)
    with pytest.raises(TypeError, match="float32"):
        fbs.fb_scan_fused(w.double(), col, pinit, 0.9)
    with pytest.raises(ValueError, match="contiguous"):
        fbs.fb_scan_bwd(w.transpose(0, 1), col.new_ones(T, S), 0.9)
