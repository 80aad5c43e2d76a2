"""The CUDA kernel of vbx_tpu_torch on a card: the kernel against its plain
twin, and the engine's kernel route on the card against the same route on
the CPU (where it runs the twin). Every test here needs a CUDA card and
skips without one.

This file imports no JAX, so on a CUDA machine without JAX it runs alone:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: tests/test_torch_fb_kernel.py's bars (the kernel and the twin
differ only in summation order and FMA contraction).
"""

import numpy as np
import pytest
import torch

from vbx_tpu_torch.engine.vbhmm import vbx_batched
from vbx_tpu_torch.ops import fb_kernel

BARS = {"float32": (2e-5, 1e-5), "bfloat16": (8e-3, 2e-3)}


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
