"""The fused forward-backward kernel's plain twin (vbx_tpu_torch.ops.fb_kernel)
against vbx_tpu's Pallas kernel run in interpret mode, on the same inputs.

On the CPU the wrapper runs the plain twin; the CUDA kernel itself is held
against the twin by tests/test_torch_gpu.py and chip_smoke.py on a card.

Tolerances are tests/test_pallas.py's bars for the Pallas kernel against
the sequential smoother: float32 gamma atol 2e-5, log_px rtol 1e-5,
pi_stat 2e-4 x max; bfloat16 streams 8e-3 / 2e-3 / 2e-2 (each stored
message is rounded to 8 mantissa bits, and the two implementations round
messages of different per-frame scale, see below). bhat is compared only
after normalizing each frame: vbx_tpu pads speakers to 8/16 sublanes and
fills padded frames with 1/S_pad, the port does not pad and uses 1/S, and
bhat is defined only up to a per-frame scale (every consumer divides it
out).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbx_tpu.ops.fb_pallas import fb_scan_pallas_sb_logp_bts as jax_fb
from vbx_tpu_torch.ops import fb_kernel
from vbx_tpu_torch.ops.fb_kernel import fb_scan_sb_logp_bts as torch_fb
from vbx_tpu_torch.testing import host_threads

from .oracle import random_hmm_problem


# several test workers share the host: keep this file's pools to one thread
@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    with host_threads(1):
        yield

BARS = {"float32": (2e-5, 1e-5, 2e-4), "bfloat16": (8e-3, 2e-3, 2e-2)}
IO = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(T, S, B, seed, loop_prob=0.9):
    """[B, T, S] log-likelihoods from random_hmm_problem, one short lane
    (25 padded frames) and, where B > 2, lane 2 with its last speaker
    absent (NEG_INF log-likelihoods, mask 0, prior 0)."""
    rng = np.random.default_rng(seed)
    log_p = np.zeros((B, T, S), np.float32)
    pi = np.zeros((B, S), np.float32)
    for b in range(B):
        lp, p, _ = random_hmm_problem(rng, T, S)
        log_p[b] = lp
        pi[b] = p
    smask = np.ones((B, S), np.float32)
    if B > 2:
        smask[2, -1] = 0.0
        log_p[2, :, -1] = -1e30
        pi[2, -1] = 0.0
        pi[2] /= pi[2].sum()
    valid = np.ones((T, B), np.float32)
    valid[T - 25:, 1] = 0.0
    col = ((1 - loop_prob) * pi + 1e-8).T.astype(np.float32)      # [S, B]
    pinit = (pi + 1e-8).T.astype(np.float32)
    return log_p, smask, valid, col, pinit


def _assemble(ahat, bhat, cfw, w, m, valid):
    """gamma [T,S,B] / log_px [B] / pi_stat [S,B] from kernel outputs, in
    the [T, S, B] order both wrappers return (mirrors the engines)."""
    ab = ahat * bhat
    denom = np.maximum(ab.sum(1, keepdims=True), 1e-37)
    gamma = ab / denom * valid[:, None, :]
    log_px = (valid * (m + np.log(cfw))).sum(0)
    nf = valid.copy()
    nf[0] = 0.0
    terms = w * bhat / (denom * cfw[:, None, :])
    return gamma, log_px, (terms * nf[:, None, :]).sum(0)


def _run_both(log_p, smask, valid, col, pinit, io, recip, binit=None,
              zero_invalid=False, loop_prob=0.9):
    jio, tio = IO[io]
    out_j = jax_fb(jnp.asarray(log_p), jnp.asarray(smask), jnp.asarray(valid),
                   jnp.asarray(col), jnp.asarray(pinit), loop_prob,
                   interpret=True, recip=recip, io_dtype=jio,
                   binit=None if binit is None else jnp.asarray(binit),
                   zero_invalid=zero_invalid)
    out_t = torch_fb(torch.from_numpy(log_p), torch.from_numpy(smask),
                     torch.from_numpy(valid), torch.from_numpy(col),
                     torch.from_numpy(pinit), loop_prob, recip=recip,
                     io_dtype=tio,
                     binit=None if binit is None else torch.from_numpy(binit),
                     zero_invalid=zero_invalid)
    assert out_t[0].dtype == tio and out_t[1].dtype == tio
    assert out_t[2].dtype == torch.float32
    return ([np.asarray(x, np.float32) for x in out_j],
            [x.float().numpy() for x in out_t])


def _norm(bhat):
    return bhat / bhat.sum(1, keepdims=True)


@pytest.mark.parametrize("recip", [False, True])
@pytest.mark.parametrize("io", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,S,B", [(40, 5, 3), (130, 31, 4)])
def test_plain_twin_matches_pallas_interpret(T, S, B, io, recip):
    gtol, ltol, ptol = BARS[io]
    log_p, smask, valid, col, pinit = _inputs(T, S, B, seed=T + S)
    j, t = _run_both(log_p, smask, valid, col, pinit, io, recip)
    vm = valid.astype(bool)
    vts = np.broadcast_to(vm[:, None, :], j[0].shape)
    # ahat and the forward normalizers directly, on valid frames
    np.testing.assert_allclose(t[0][vts], j[0][vts], atol=gtol)
    np.testing.assert_allclose(t[2][vm], j[2][vm], rtol=ltol)
    np.testing.assert_array_equal(t[3], j[3])                     # m
    np.testing.assert_allclose(_norm(t[1])[vts], _norm(j[1])[vts], atol=gtol)
    g_j, lpx_j, ps_j = _assemble(j[0], j[1], j[2], j[4], j[3], valid)
    g_t, lpx_t, ps_t = _assemble(t[0], t[1], t[2], t[4], t[3], valid)
    np.testing.assert_allclose(g_t, g_j, atol=gtol)
    assert np.all(g_t[~vts] == 0)
    np.testing.assert_allclose(lpx_t, lpx_j, rtol=ltol)
    np.testing.assert_allclose(ps_t, ps_j, atol=ptol * float(ps_j.max()))


@pytest.mark.parametrize("io", ["float32", "bfloat16"])
def test_plain_twin_skip_dead_with_boundary_message(io):
    """zero_invalid: padded frames are all-zero w columns that the walk
    skips exactly (skip_dead), so a non-uniform boundary message binit
    reaches the last valid frame unchanged."""
    gtol, ltol, _ = BARS[io]
    T, S, B = 60, 7, 3
    log_p, smask, valid, col, pinit = _inputs(T, S, B, seed=5)
    rng = np.random.default_rng(6)
    binit = rng.uniform(0.1, 1.0, (S, B)).astype(np.float32)
    binit[-1, 2] = 0.0                     # lane 2's absent speaker
    binit /= binit.sum(0, keepdims=True)
    j, t = _run_both(log_p, smask, valid, col, pinit, io, recip=True,
                     binit=binit, zero_invalid=True)
    vm = valid.astype(bool)
    vts = np.broadcast_to(vm[:, None, :], j[0].shape)
    np.testing.assert_allclose(t[0][vts], j[0][vts], atol=gtol)
    np.testing.assert_allclose(_norm(t[1])[vts], _norm(j[1])[vts], atol=gtol)
    np.testing.assert_allclose(t[2][vm], j[2][vm], rtol=ltol)
    # skipped frames: cfw exactly 1, the carry passes through unchanged
    assert np.all(t[2][~vm] == 1.0)
    np.testing.assert_array_equal(t[1][T - 25, :, 1], t[1][T - 1, :, 1])
    np.testing.assert_allclose(_norm(t[1])[T - 26, :, 1],
                               _norm(j[1])[T - 26, :, 1], atol=gtol)


def test_plain_twin_recip_matches_divide():
    """recip=True (reciprocal-multiply normalization) agrees with the
    divide form to float32 roundoff (tests/test_pallas.py bar: 1e-6)."""
    rng = np.random.default_rng(11)
    B, T, S = 4, 96, 6
    w = torch.from_numpy(rng.uniform(0.05, 1.0, (B, T, S)).astype(np.float32))
    pi = torch.from_numpy(rng.dirichlet(np.ones(S), size=B).astype(np.float32))
    col, pinit = 0.1 * pi + 1e-8, pi + 1e-8
    binit = torch.full((B, S), 1.0 / S)
    a0, b0, c0 = fb_kernel.fb_fused_sb(w, col, pinit, binit, 0.9)
    a1, b1, c1 = fb_kernel.fb_fused_sb(w, col, pinit, binit, 0.9, recip=True)
    np.testing.assert_allclose(a1.numpy(), a0.numpy(), atol=1e-6)
    np.testing.assert_allclose(b1.numpy(), b0.numpy(), atol=1e-6)
    np.testing.assert_allclose(c1.numpy(), c0.numpy(), rtol=1e-6)


def test_wrapper_runs_twin_only_for_cpu_tensors():
    """CPU tensors take the plain twin without counting a launch; tensors
    on any other non-CUDA device are refused, never moved to the CPU."""
    B, T, S = 2, 5, 3
    args = [torch.rand(B, T, S)] + [torch.rand(B, S) for _ in range(3)]
    before = fb_kernel.fb_fused_sb.launches
    fb_kernel.fb_fused_sb(*args, 0.9)
    assert fb_kernel.fb_fused_sb.launches == before
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fb_kernel.fb_fused_sb(*meta, 0.9)
    with pytest.raises(ValueError, match="speakers"):
        S = fb_kernel.S_MAX + 1
        fb_kernel.fb_fused_sb(torch.rand(1, 2, S), *[torch.rand(1, S)] * 3,
                              0.9)
