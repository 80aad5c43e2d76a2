"""The CUDA kernels of vbx_tpu_torch on a card: each kernel against its
plain twin, and the engines' kernel routes on the card against the same
routes on the CPU (where they run the twins). Every test here needs a CUDA
card and skips without one.

This file imports no JAX, so on a CUDA machine without JAX it runs alone:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: tests/test_torch_fb_kernel.py's bars for K1 and
K2_CARD_BAR below for K2 (a kernel and its twin differ only in summation
order and FMA contraction).
"""

import numpy as np
import pytest
import torch

from vbx_tpu_torch.engine.vbhmm import vbx_batched
from vbx_tpu_torch.ops import fb_kernel
from vbx_tpu_torch.ops import fb_product_kernel as k2
from vbx_tpu_torch.parallel import make_mesh, vbx_sharded

BARS = {"float32": (2e-5, 1e-5), "bfloat16": (8e-3, 2e-3)}
# K2 against its twin: both walk in float32 on the same stream values, but
# the kernel sums a row's S products in a shuffle butterfly and the twin in
# torch's order; at S=128 that alone moved fhat by 1.02e-6 of its row's
# max on an H100. 4e-6 covers the 128-term sums with room; ls the same.
K2_CARD_BAR = 4e-6


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("io", ["float32", "bfloat16"])
@pytest.mark.parametrize("recip,skip_dead", [(True, False), (False, True)])
@pytest.mark.parametrize("S", [31, 64, 256, 300, 1000])
def test_cuda_kernel_matches_plain_twin(io, recip, skip_dead, S):
    """ahat / normalized bhat at the gamma bar, cfw at the log_px bar; the
    launch counter counts the kernel launch. S covers one warp per chain
    with one and several speakers per thread (31, 64, 256) and the
    several-warp chains past 256 (300, 1000)."""
    _need_card()
    gtol, ltol = BARS[io]
    gen = torch.Generator(device="cuda").manual_seed(S)
    B, T = 5, 130
    w = torch.rand((B, T, S), generator=gen, device="cuda")
    if skip_dead:
        w[:, 40:43] = 0.0
    w = w.to(getattr(torch, io))
    pi = torch.rand((B, S), generator=gen, device="cuda")
    pi /= pi.sum(-1, keepdim=True)
    col, pinit = 0.1 * pi + 1e-8, pi + 1e-8
    binit = torch.rand((B, S), generator=gen, device="cuda")
    before = fb_kernel.fb_fused_sb.launches
    k = fb_kernel.fb_fused_sb(w, col, pinit, binit, 0.9, recip, skip_dead)
    assert fb_kernel.fb_fused_sb.launches == before + 1
    p = fb_kernel.fb_fused_sb_plain(w, col, pinit, binit, 0.9, recip,
                                    skip_dead)
    torch.cuda.synchronize()
    torch.testing.assert_close(k[0].float(), p[0].float(), atol=gtol, rtol=0)
    kb, pb = k[1].float(), p[1].float()
    torch.testing.assert_close(kb / kb.sum(-1, keepdim=True),
                               pb / pb.sum(-1, keepdim=True),
                               atol=gtol, rtol=0)
    torch.testing.assert_close(k[2], p[2], rtol=ltol, atol=0)


@pytest.mark.gpu
def test_cuda_kernel_route_matches_cpu_route():
    """vbx_batched(fb_impl='pallas') on the card (the kernel) and on the CPU
    (the plain twin): same iteration counts, gamma within 5e-4, ELBO within
    1e-4 relative (the pallas-vs-structured bars of tests/test_pallas.py)."""
    _need_card()
    rng = np.random.default_rng(7)
    B, T, S, D = 6, 80, 5, 16
    centers = rng.standard_normal((B, S, D)) * 2.0
    z = rng.integers(0, S, size=(B, T))
    X = (centers[np.arange(B)[:, None], z]
         + rng.standard_normal((B, T, D))).astype(np.float32)
    phi = rng.uniform(0.5, 5.0, size=D).astype(np.float32)
    G = rng.dirichlet(np.ones(S), size=(B, T)).astype(np.float32)
    PI = np.full((B, S), 1.0 / S, np.float32)
    FM = np.ones((B, T), bool)
    FM[1, 60:] = False
    SM = np.ones((B, S), bool)
    kw = dict(loop_prob=0.9, Fa=0.4, Fb=11.0, max_iters=8, epsilon=1e-6,
              fb_impl="pallas")
    before = fb_kernel.fb_fused_sb.launches
    gpu = vbx_batched(X, phi, G, PI, FM, SM, device="cuda", **kw)
    assert fb_kernel.fb_fused_sb.launches > before
    cpu = vbx_batched(X, phi, G, PI, FM, SM, device="cpu", **kw)
    np.testing.assert_array_equal(gpu.n_iters.cpu().numpy(),
                                  cpu.n_iters.numpy())
    np.testing.assert_allclose(gpu.gamma.cpu().numpy(), cpu.gamma.numpy(),
                               atol=5e-4)
    np.testing.assert_allclose(gpu.elbo.cpu().numpy(), cpu.elbo.numpy(),
                               rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("io", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [8, 31, 33, 64, 100, 128])
def test_k2_cuda_kernel_matches_plain_twin(io, S):
    """K2 against its twin, fhat relative to each row's max and ls relative
    to max(1, |ls|). S covers one speaker per thread in groups of 8 and 32
    lanes and 2-4 speakers per thread; lane 1's padding suffix leaves a
    partly dead segment and one wholly dead segment (skipped exactly)."""
    _need_card()
    bar = K2_CARD_BAR
    gen = torch.Generator(device="cuda").manual_seed(S)
    B, Tb, R = 3, 256, 4
    w = torch.rand((B, Tb, S), generator=gen, device="cuda")
    w[1, 150:] = 0.0
    w[2, :, -1] = 0.0
    w = w.to(getattr(torch, io))
    pi = torch.rand((B, S), generator=gen, device="cuda")
    col = 0.1 * pi / pi.sum(-1, keepdim=True) + 1e-8
    eye = torch.eye(S, device="cuda")
    finit = (0.9 * eye + col[:, None, :]).expand(R, B, S, S).clone()
    finit[0] = eye
    before = k2.fb_fwd_product_sb.launches
    fk, lk = k2.fb_fwd_product_sb(w, col, finit, 0.9)
    assert k2.fb_fwd_product_sb.launches == before + 1
    fp, lpl = k2.fb_fwd_product_sb_plain(w, col, finit, 0.9)
    torch.cuda.synchronize()
    rowmax = fp.abs().amax(-1, keepdim=True)
    assert float(((fk - fp).abs() / rowmax).max()) <= bar
    assert float(((lk - lpl).abs() / lpl.abs().clamp(min=1.0)).max()) <= bar
    assert torch.equal(fk[3, 1], finit[3, 1])
    assert torch.all(lk[3, 1] == 0)


def _sharded_problem(S, B=4, T=128, D=16, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((B, S, D)) * 2.0
    z = rng.integers(0, S, size=(B, T))
    X = (centers[np.arange(B)[:, None], z]
         + rng.standard_normal((B, T, D))).astype(np.float32)
    phi = rng.uniform(0.5, 5.0, size=D).astype(np.float32)
    G = rng.dirichlet(np.ones(S), size=(B, T)).astype(np.float32)
    PI = np.full((B, S), 1.0 / S, np.float32)
    FM = np.ones((B, T), bool)
    FM[1, 90:] = False
    return X, phi, G, PI, FM, np.ones((B, S), bool)


@pytest.mark.gpu
def test_sharded_kernel_route_on_a_card_matches_cpu_route():
    """vbx_sharded(fb_impl='pallas') on a 2x2 mesh of cuda:0 repeated (K2
    and K1) against the same mesh of CPU copies (their twins): same
    iteration counts, gamma within 5e-4, ELBO 1e-4 relative."""
    _need_card()
    args = _sharded_problem(5)
    kw = dict(loop_prob=0.9, Fa=0.4, Fb=11.0, max_iters=8, epsilon=1e-3,
              fb_impl="pallas")
    n1, n2 = fb_kernel.fb_fused_sb.launches, k2.fb_fwd_product_sb.launches
    gpu = vbx_sharded(make_mesh(2, 2, devices=["cuda:0"] * 4), *args, **kw)
    assert fb_kernel.fb_fused_sb.launches > n1
    assert k2.fb_fwd_product_sb.launches > n2
    cpu = vbx_sharded(make_mesh(2, 2, device="cpu"), *args, **kw)
    np.testing.assert_array_equal(gpu.n_iters.cpu().numpy(),
                                  cpu.n_iters.numpy())
    np.testing.assert_allclose(gpu.gamma.cpu().numpy(), cpu.gamma.numpy(),
                               atol=5e-4)
    np.testing.assert_allclose(gpu.elbo.cpu().numpy(), cpu.elbo.numpy(),
                               rtol=1e-4)


@pytest.mark.gpu
def test_sharded_kernel_route_past_k2_cap_raises_on_a_card():
    """On a card the sharded kernel route never leaves the kernels: past
    K2's S_MAX speakers it raises (the CPU warns and runs structured)."""
    _need_card()
    args = _sharded_problem(k2.S_MAX + 2, T=32)
    with pytest.raises(ValueError, match="speakers"):
        vbx_sharded(make_mesh(1, 2, devices=["cuda:0"] * 2), *args,
                    loop_prob=0.9, Fa=0.4, Fb=11.0, max_iters=2,
                    fb_impl="pallas")
