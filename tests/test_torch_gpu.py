"""The CUDA kernels of vbx_tpu_torch on a card: each kernel against its
plain twin, and the engines' kernel routes on the card against the same
routes on the CPU (where they run the twins). Every test here needs a CUDA
card and skips without one.

This file imports no JAX, so on a CUDA machine without JAX it runs alone:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: tests/test_torch_fb_kernel.py's bars for K1, K2_CARD_BAR
below for K2, and for K3-K5 ahat and per-frame-normalized bhat 2e-5, cfw
1e-5 relative (a kernel and its twin differ only in summation order and
FMA contraction).
"""

import os

import numpy as np
import pytest
import torch

from vbx_tpu_torch.engine.vbhmm import vbx_batched, vbx_batched_checkpointed
from vbx_tpu_torch.ops import fb_kernel
from vbx_tpu_torch.ops import fb_scan_kernel as fbs
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
@pytest.mark.parametrize("B,T", [(5, 130), (37, 3), (3, 1), (3, 2), (7, 63),
                                 (9, 65), (5, 127), (6, 129)])
@pytest.mark.parametrize("S", [1, 2, 8, 9, 31, 33, 64, 256, 300, 1000])
def test_cuda_kernel_matches_plain_twin(io, recip, skip_dead, B, T, S):
    """ahat / normalized bhat at the gamma bar, cfw at the log_px bar; the
    launch counter counts the kernel launch. S covers every group shape of
    the one-warp form (1 to 32 threads a lane, 4 or 8 speakers a thread,
    full and ragged) and the several-warp chains past 256 (300, 1000); B
    and T cover batches that do not fill a warp, walks of 1-3 frames and
    walks one frame under and over a staged chunk (S=31: 64 frames in
    float32, 128 in bfloat16), and with odd T and S lanes that start at odd
    byte offsets. With skip_dead lane 0 starts with dead frames and the
    last lane is all dead; without it two frames of lane 1 are scaled by
    1e-38, so that their sums lie under the 1e-37 floor."""
    _need_card()
    gtol, ltol = BARS[io]
    gen = torch.Generator(device="cuda").manual_seed(S)
    w = torch.rand((B, T, S), generator=gen, device="cuda")
    if skip_dead:
        w[:, 40:43] = 0.0
        w[0, :min(3, T - 1)] = 0.0
        w[B - 1] = 0.0
    elif T > 7:
        w[1, 5:7] *= 1e-38
    w = w.to(getattr(torch, io))
    pi = torch.rand((B, S), generator=gen, device="cuda")
    pi /= pi.sum(-1, keepdim=True)
    col, pinit = 0.1 * pi + 1e-8, pi + 1e-8
    binit = torch.rand((B, S), generator=gen, device="cuda") + 0.05
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
    if skip_dead:
        assert torch.all(k[2][w.float().sum(-1) == 0] == 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("io", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [2, 8, 31, 33, 300])
def test_cuda_kernel_lane_does_not_depend_on_its_batch(io, S):
    """A lane of a batch of 70 is bit-equal to the same lane launched alone
    and at another place among other neighbours: the group of threads that
    holds a lane depends on S only, and sums never cross lanes."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(S)
    B, T = 70, 97
    w = torch.rand((B, T, S), generator=gen, device="cuda")
    w[3, 10:14] = 0.0
    w = w.to(getattr(torch, io))
    pi = torch.rand((B, S), generator=gen, device="cuda")
    pi /= pi.sum(-1, keepdim=True)
    col, pinit = 0.1 * pi + 1e-8, pi + 1e-8
    binit = torch.rand((B, S), generator=gen, device="cuda") + 0.05

    def run(idx):
        return fb_kernel.fb_fused_sb(
            w[idx].contiguous(), col[idx].contiguous(),
            pinit[idx].contiguous(), binit[idx].contiguous(), 0.9, True,
            True)

    full = run(slice(None))
    for i in (0, 3, 33, B - 1):
        alone = run(slice(i, i + 1))
        among = run(torch.tensor([(i + 9) % B, 60, i, 2], device="cuda"))
        torch.cuda.synchronize()
        for f, a, m in zip(full, alone, among):
            assert torch.equal(f[i], a[0])
            assert torch.equal(f[i], m[2])


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
@pytest.mark.parametrize("B,Tb,R", [(3, 256, 4), (2, 96, 4), (2, 300, 3),
                                    (1, 5, 1)])
@pytest.mark.parametrize("S", [1, 2, 8, 9, 31, 33, 64, 100, 128])
def test_k2_cuda_kernel_matches_plain_twin(io, S, B, Tb, R):
    """K2 against its twin, fhat relative to each row's max and ls relative
    to max(1, |ls|). S covers every group shape (1 to 32 threads a row,
    full and ragged); the last lane's padding suffix leaves a partly dead
    segment and a wholly dead last segment (skipped exactly); Tb and R
    give segments of several staged chunks, of less than one, and of no
    whole number of them (S=8: 64 frames a chunk). Then a lane's rows must
    not depend on the lanes it is launched with."""
    _need_card()
    bar = K2_CARD_BAR
    gen = torch.Generator(device="cuda").manual_seed(S)
    Ts = Tb // R
    w = torch.rand((B, Tb, S), generator=gen, device="cuda")
    w[B - 1, Tb - Ts // 3 - (Ts if R > 1 else 0):] = 0.0
    if S > 1 and B > 1:
        w[0, :, -1] = 0.0
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
    rowmax = fp.abs().amax(-1, keepdim=True).clamp(min=1e-37)
    assert float(((fk - fp).abs() / rowmax).max()) <= bar
    assert float(((lk - lpl).abs() / lpl.abs().clamp(min=1.0)).max()) <= bar
    if R > 1:
        assert torch.equal(fk[R - 1, B - 1], finit[R - 1, B - 1])
        assert torch.all(lk[R - 1, B - 1] == 0)
    back = torch.arange(B - 1, -1, -1, device="cuda")
    fr, lr = k2.fb_fwd_product_sb(w[back].contiguous(), col[back].contiguous(),
                                  finit[:, back].contiguous(), 0.9)
    fa, la = k2.fb_fwd_product_sb(w[:1], col[:1], finit[:, :1].contiguous(),
                                  0.9)
    torch.cuda.synchronize()
    assert torch.equal(fr[:, back], fk) and torch.equal(lr[:, back], lk)
    assert torch.equal(fa[:, 0], fk[:, 0]) and torch.equal(la[:, 0], lk[:, 0])


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


def _scan_case(T, B, S, seed, floor=False):
    """Emission weights (max 1 per frame) with lane 0's last speaker absent
    and, where B > 1, lane 1 ending in a padded suffix (valid = 0); with
    floor two frames of lane 0 scaled by 1e-38, so that (S <= 9) their sums
    lie under the 1e-37 floor."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    log_p = 3.0 * torch.randn((T, B, S), generator=gen, device="cuda")
    w = torch.exp(log_p - log_p.amax(-1, keepdim=True))
    pi = torch.rand((B, S), generator=gen, device="cuda")
    if S > 1:
        w[:, 0, -1] = 0.0
        pi[0, -1] = 0.0
    if floor:
        w[T // 3:T // 3 + 2, 0] *= 1e-38
    pi /= pi.sum(-1, keepdim=True)
    valid = torch.ones((T, B), device="cuda")
    if B > 1:
        valid[T - T // 4:, 1] = 0.0
    return w, valid, 0.1 * pi + 1e-8, pi + 1e-8


@pytest.mark.gpu
@pytest.mark.parametrize("T,B,S,floor", [
    (40, 3, 5, False), (600, 4, 31, False), (130, 1, 6, False),
    (90, 7, 33, False), (60, 5, 64, False), (50, 6, 128, False),
    (3, 9, 100, False), (1, 2, 4, False),
    (1, 5, 31, False), (2, 5, 31, False), (3, 3, 8, False),
    (15, 5, 31, False), (17, 5, 31, False), (63, 5, 1, False),
    (65, 37, 1, False), (47, 9, 3, False), (33, 11, 9, False),
    (200, 5, 8, True), (120, 4, 3, True)])
def test_fb_scan_cuda_kernels_match_plain_twins(T, B, S, floor):
    """K3, K4 and K5 against their twins on the filled weights fb_scan
    hands them; each wrapper counts its launch, and K4's ahat is K3's bit
    for bit (the same forward body). The shapes cover every group shape of
    the three kernels (S=1 and 3: 32 lanes a warp; 5-8: 16; 9: 8; 31: 4;
    33-64: 2; 100-128: 1) with batches that do not fill a warp, walks of
    1-3 frames, walks one frame under and over one staged chunk (S=31: 16
    rows; S=1: 64), and frames whose sum lies under the 1e-37 floor."""
    _need_card()
    w, valid, col, pinit = _scan_case(T, B, S, seed=T + S, floor=floor)
    vm = valid[:, :, None]
    wf = (w * vm + (1 - vm) / S).contiguous()
    ok = valid.bool()

    def norm(b):
        return b / b.sum(-1, keepdim=True)

    n3, n4, n5 = (f.launches for f in (fbs.fb_scan_fused, fbs.fb_scan_fwd,
                                       fbs.fb_scan_bwd))
    a3, b3 = fbs.fb_scan_fused(wf, col, pinit, 0.9)
    a4, c4 = fbs.fb_scan_fwd(wf, col, pinit, 0.9)
    b5 = fbs.fb_scan_bwd(wf, col, 0.9)
    assert (fbs.fb_scan_fused.launches, fbs.fb_scan_fwd.launches,
            fbs.fb_scan_bwd.launches) == (n3 + 1, n4 + 1, n5 + 1)
    ap, cp = fbs.fb_scan_fwd_plain(wf, col, pinit, 0.9)
    bp = fbs.fb_scan_bwd_plain(wf, col, 0.9)
    torch.cuda.synchronize()
    assert torch.equal(a3, a4)
    for a in (a3, a4):
        torch.testing.assert_close(a[ok], ap[ok], atol=2e-5, rtol=0)
    for b in (b3, b5):
        torch.testing.assert_close(norm(b)[ok], norm(bp)[ok], atol=2e-5,
                                   rtol=0)
    torch.testing.assert_close(c4[ok], cp[ok], rtol=1e-5, atol=0)
    # the two routes of the API agree with each other on the card
    f = fbs.fb_scan(w, valid, col, pinit, 0.9, fused=True)
    t = fbs.fb_scan(w, valid, col, pinit, 0.9, fused=False)
    torch.testing.assert_close(f[2][ok], t[2][ok], rtol=1e-5, atol=0)
    torch.testing.assert_close(f[0][ok], t[0][ok], atol=1e-6, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 9, 31, 33, 128])
def test_fb_scan_lanes_do_not_depend_on_their_batch(S):
    """K3, K4 and K5: a lane of a batch of 70 (ahat, bhat and K4's cfw) is
    bit-equal to the same lane launched alone and at another place among
    other neighbours (the group that holds a lane depends on S only, and a
    warp's lanes never exchange values)."""
    _need_card()
    T, B = 97, 70
    w, valid, col, pinit = _scan_case(T, B, S, seed=S)
    vm = valid[:, :, None]
    wf = (w * vm + (1 - vm) / S).contiguous()

    def run(idx):
        args = (wf[:, idx].contiguous(), col[idx].contiguous())
        p = pinit[idx].contiguous()
        return (*fbs.fb_scan_fused(*args, p, 0.9),
                *fbs.fb_scan_fwd(*args, p, 0.9), fbs.fb_scan_bwd(*args, 0.9))

    full = run(slice(None))
    for i in (0, 1, 33, B - 1):
        alone = run(slice(i, i + 1))
        among = run(torch.tensor([(i + 9) % B, 60, i, 2], device="cuda"))
        torch.cuda.synchronize()
        for f, a, m in zip(full, alone, among):
            assert torch.equal(f[:, i], a[:, 0])
            assert torch.equal(f[:, i], m[:, 2])


@pytest.mark.gpu
def test_fb_scan_on_a_card_refuses_what_the_kernels_do_not_take():
    _need_card()
    S = fbs.S_MAX + 1
    w = torch.rand((4, 2, S), device="cuda")
    v = torch.rand((2, S), device="cuda")
    with pytest.raises(ValueError, match="shard speakers first"):
        fbs.fb_scan(w, torch.ones((4, 2), device="cuda"), v, v, 0.9)
    with pytest.raises(ValueError, match="shard speakers first"):
        fbs.fb_scan_bwd(w, v, 0.9)
    w = torch.rand((4, 2, 8), device="cuda")
    with pytest.raises(ValueError, match="contiguous on"):
        fbs.fb_scan_fused(w, torch.rand((2, 8)), torch.rand((2, 8)), 0.9)


@pytest.mark.gpu
def test_checkpointed_kernel_route_on_a_card_is_bit_equal(tmp_path):
    """vbx_batched_checkpointed(fb_impl='pallas') on the card, sliced and
    resumed from its file after a simulated stop, equals the unsliced
    vbx_batched run bit for bit (same kernels at the same shapes; nothing
    on the route sums with atomics)."""
    _need_card()
    import vbx_tpu_torch.engine.vbhmm as vbhmm_mod

    rng = np.random.default_rng(7)
    B, T, S, D = 18, 50, 5, 8
    centers = rng.standard_normal((B, S, D)) * 2.0
    z = rng.integers(0, S, size=(B, T))
    X = (centers[np.arange(B)[:, None], z]
         + rng.standard_normal((B, T, D))).astype(np.float32)
    phi = rng.uniform(0.5, 5.0, size=D).astype(np.float32)
    G = rng.dirichlet(np.ones(S), size=(B, T)).astype(np.float32)
    PI = np.full((B, S), 1.0 / S, np.float32)
    FM = np.ones((B, T), bool)
    FM[1, 35:] = False
    SM = np.ones((B, S), bool)
    kw = dict(loop_prob=0.9, Fa=0.4, Fb=11.0, max_iters=25, epsilon=1e-5,
              fb_impl="pallas", device="cuda")
    ref = vbx_batched(X, phi, G, PI, FM, SM, **kw)
    ck = str(tmp_path / "vb_state.npz")
    real = vbhmm_mod.vbx_batched
    calls = {"n": 0}

    def dying(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt("simulated stop")
        return real(*a, **k)

    vbhmm_mod.vbx_batched = dying
    try:
        with pytest.raises(KeyboardInterrupt):
            vbx_batched_checkpointed(X, phi, G, PI, FM, SM, **kw,
                                     iters_per_slice=4, checkpoint_path=ck)
    finally:
        vbhmm_mod.vbx_batched = real
    assert os.path.exists(ck)
    out = vbx_batched_checkpointed(X, phi, G, PI, FM, SM, **kw,
                                   iters_per_slice=4, checkpoint_path=ck)
    assert not os.path.exists(ck)
    assert torch.equal(out.n_iters, ref.n_iters)
    assert torch.equal(out.gamma, ref.gamma)
    assert torch.equal(out.pi, ref.pi)
    np.testing.assert_array_equal(out.elbo.cpu().numpy(),
                                  ref.elbo.cpu().numpy())


@pytest.mark.gpu
def test_extraction_on_a_card_matches_the_cpu():
    """A small extraction on the card against the same on the CPU, at
    chip_smoke.py phase 7's bars: equal keys and times; extract_file's
    float32 x-vectors on the card against the CPU's, cosine 0.99999 and
    2e-4 x max; features within 1e-3; the float32 model on the same windows within cosine 0.99999 and
    2e-4 x max; padded tails within 2e-4 x max of their true-length runs;
    bfloat16 against float32 on the card, cosine > 0.999."""
    _need_card()
    from vbx_tpu_torch.device import full_fp32_matmuls
    from vbx_tpu_torch.engine.extractor import XVectorExtractor
    from vbx_tpu_torch.models.resnet import Bottleneck, ResNetXVector
    from vbx_tpu_torch.testing import synth_audio

    signal, segs = synth_audio(np.random.default_rng(0), 20.0)
    torch.manual_seed(0)
    models = {k: ResNetXVector(Bottleneck, (1, 2, 2, 1), 16, 64, 64,
                               dtype=dt)
              for k, dt in (("cpu", torch.float32), ("f32", torch.float32),
                            ("bf16", torch.bfloat16))}
    for k in ("f32", "bf16"):
        models[k].load_state_dict(models["cpu"].state_dict())
    ex = {k: XVectorExtractor(m, 16000, batch_size=16,
                              device="cpu" if k == "cpu" else "cuda")
          for k, m in models.items()}
    out = {k: e.extract_file(signal, segs, "r") for k, e in ex.items()}
    meta = [(s.key, s.start, s.end) for s in out["cpu"]]
    assert len(meta) > 16
    for k in ("f32", "bf16"):
        assert [(s.key, s.start, s.end) for s in out[k]] == meta
    h, a, b = (np.stack([s.xvector for s in out[k]])
               for k in ("cpu", "f32", "bf16"))
    # extract_file's own route (unmasked full batches, a masked last one)
    # on the card against the CPU's, same weights
    cos = (a * h).sum(1) / (np.linalg.norm(a, axis=1)
                            * np.linalg.norm(h, axis=1))
    assert cos.min() >= 0.99999, cos.min()
    np.testing.assert_allclose(a, h, rtol=0, atol=2e-4 * np.abs(h).max())
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                            * np.linalg.norm(b, axis=1))
    assert cos.min() > 0.999, cos.min()

    with torch.inference_mode(), full_fp32_matmuls():
        fc = ex["f32"].features(signal, segs)
        fh = ex["cpu"].features(signal, segs)
        assert fc.segments == fh.segments
        assert float((fc.stream.cpu() - fh.stream).abs().max()) <= 1e-3
        starts, _, _ = ex["f32"].windows(fc, "r")
        st = torch.tensor(starts[:14] + starts[14:16], device="cuda")
        ln = torch.tensor([144] * 14 + [10, 77], device="cuda")
        card = ex["f32"].embed_batch(fc.stream, st, ln).cpu().numpy()
        cpu = ex["cpu"].embed_batch(fc.stream.cpu(), st.cpu(),
                                    ln.cpu()).numpy()
        ar = torch.arange(144, device="cuda")
        win = fc.stream[st[:, None] + ar[None, :]].transpose(1, 2)
        alone = np.stack([models["f32"](win[i:i + 1, :, :int(ln[i])]
                                        .contiguous())[0].cpu().numpy()
                          for i in (14, 15)])
    cos = (card * cpu).sum(1) / (np.linalg.norm(card, axis=1)
                                 * np.linalg.norm(cpu, axis=1))
    assert cos.min() >= 0.99999, cos.min()
    np.testing.assert_allclose(card, cpu, rtol=0,
                               atol=2e-4 * np.abs(cpu).max())
    np.testing.assert_allclose(card[14:], alone, rtol=0,
                               atol=2e-4 * np.abs(alone).max())
