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
def test_dryrun_multichip_on_the_cards():
    """vbx_tpu's multi-device dryrun over the visible cards (cuda:0 four
    times on a one-card machine): its four checks hold, and its kernel
    route launched K2 and K1."""
    _need_card()
    from vbx_tpu_torch.parallel.dryrun import dryrun_multichip

    n_cards = torch.cuda.device_count()
    devices = (None if n_cards >= 2 else ["cuda:0"] * 4)
    n = n_cards if n_cards >= 2 else 4
    n1, n2 = fb_kernel.fb_fused_sb.launches, k2.fb_fwd_product_sb.launches
    out = dryrun_multichip(n, devices=devices)
    assert len(out["checks"]) == 4 and len(out["devices"]) == n
    assert fb_kernel.fb_fused_sb.launches > n1
    assert k2.fb_fwd_product_sb.launches > n2


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


def _walk_inputs(ns, D, seed, K=8):
    """[M, max(ns), D] float64 l2-normalized clustered rows (lane m's first
    ns[m] valid) and each lane's rows."""
    rng = np.random.default_rng(seed)
    xs = []
    for n in ns:
        centers = rng.standard_normal((K, D))
        x = centers[rng.integers(0, K, n)] + 0.5 * rng.standard_normal((n, D))
        xs.append(x / np.linalg.norm(x, axis=1, keepdims=True))
    sums = np.zeros((len(ns), max(ns), D))
    for m, x in enumerate(xs):
        sums[m, :len(x)] = x
    return torch.from_numpy(sums), xs


def _labels_at_cuts(Z, Zref, n, qs=(0.3, 0.7)):
    """Flat labels of Z and of the reference Zref at cuts placed at
    Zref's merge-gap midpoints (tests/test_clustering.py's contract)."""
    from vbx_tpu_torch.clustering import fcluster_by_distance
    adjust = abs(Zref[:, 2].min())
    ds = np.sort(Zref[:, 2])
    out = []
    for q in qs:
        i = int(q * (n - 1))
        cut = 0.5 * (ds[i] + ds[i + 1]) + adjust
        out.append(tuple(fcluster_by_distance(
            np.c_[z[:, :2], z[:, 2] + adjust, z[:, 3]], cut)
            for z in (Z, Zref)))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("ns,D", [((2,), 4), ((3, 1, 0), 16), ((517,), 16),
                                  ((1024, 300), 128), ((700,), 33),
                                  ((2048,), 256)])
def test_nn_chain_kernel_matches_plain_twin(ns, D):
    """The walk kernel against its plain twin on the card: sorted merge
    distances within 1e-12 (both float64; the dots are summed in other
    orders), labels equal at two gap-midpoint cuts, every merge covering
    N at the end, no lane bad, one launch a call; where the two made the
    same merges in the same order, the same steps and scanned clusters."""
    _need_card()
    from vbx_tpu_torch.clustering import device as cdev

    sums, xs = _walk_inputs(ns, D, seed=len(ns) * 7 + D)
    before = cdev.nn_chain_walk.launches
    k_out = cdev.nn_chain_walk(sums.cuda(), ns)
    assert cdev.nn_chain_walk.launches == before + 1
    p_out = cdev.nn_chain_walk_plain(sums.cuda(), ns)
    torch.cuda.synchronize()
    assert not k_out[3].any() and not p_out[3].any()
    for m, n in enumerate(ns):
        if n < 2:
            continue
        Zk, Zp = (cdev._finalize(o[0][m, :n - 1].cpu().numpy(),
                                 o[1][m, :n - 1].cpu().numpy(),
                                 o[2][m, :n - 1].cpu().numpy(), n)
                  for o in (k_out, p_out))
        assert np.abs(np.sort(Zk[:, 2]) - np.sort(Zp[:, 2])).max() < 1e-12
        assert Zk[-1, 3] == n
        if all(torch.equal(k_out[j][m].cpu(), p_out[j][m].cpu())
               for j in (0, 1)):
            # the same merges in the same order: the same steps and scans
            assert int(k_out[4][m]) == int(p_out[4][m])
            assert int(k_out[5][m]) == int(p_out[5][m])
        if n > 3:
            for lk, lp in _labels_at_cuts(Zk, Zp, n):
                np.testing.assert_array_equal(lk, lp)


@pytest.mark.gpu
def test_nn_chain_kernel_lane_does_not_depend_on_its_batch():
    """A lane's merges and distances are bit-equal alone, among other
    lanes (another order, other sizes), and at another grid size."""
    _need_card()
    from vbx_tpu_torch.clustering import device as cdev

    ns = (900, 1500, 333, 1200)
    sums, _ = _walk_inputs(ns, 128, seed=3)
    sums = sums.cuda()
    full = cdev.nn_chain_walk(sums, ns)
    grids = [cdev.nn_chain_walk(sums, ns, blocks_per_sm=b) for b in (1, 2)]
    for m, n in enumerate(ns):
        alone = cdev.nn_chain_walk(sums[m:m + 1, :n].contiguous(), [n])
        rev = cdev.nn_chain_walk(sums.flip(0).contiguous(), ns[::-1])
        assert int(full[5][m]) == int(alone[5][0])
        for j in range(3):
            assert torch.equal(full[j][m, :n - 1], alone[j][0, :n - 1])
            assert torch.equal(full[j][m, :n - 1],
                               rev[j][len(ns) - 1 - m, :n - 1])
            for other_grid in grids:
                assert torch.equal(full[j][m, :n - 1],
                                   other_grid[j][m, :n - 1])
    assert not full[3].any()


def _integer_walk_inputs(ns, D, seed, levels=2, dup=()):
    """[M, max(ns), D] float64 rows with integer entries in [-levels,
    levels]: every dot is an exact integer in any summation order, so the
    kernel and its twin see the same distances to the bit and break the
    same exact ties. `dup` lists (lane, row, copy of row) pairs."""
    rng = np.random.default_rng(seed)
    sums = np.zeros((len(ns), max(ns), D))
    for m, n in enumerate(ns):
        sums[m, :n] = rng.integers(-levels, levels + 1, (n, D))
    for m, i, j in dup:
        sums[m, i] = sums[m, j]
    return torch.from_numpy(sums)


def _assert_walks_equal(k_out, p_out, ns):
    """Every output of every lane bit-equal (bad all clear)."""
    assert not k_out[3].any() and not p_out[3].any()
    for m, n in enumerate(ns):
        k = max(n - 1, 0)
        for j in range(3):
            assert torch.equal(k_out[j][m, :k].cpu(), p_out[j][m, :k].cpu()), \
                (m, n, j)
        assert int(k_out[4][m]) == int(p_out[4][m]), (m, n)
        assert int(k_out[5][m]) == int(p_out[5][m]), (m, n)


@pytest.mark.gpu
@pytest.mark.parametrize("blocks_per_sm", [1, 2])
@pytest.mark.parametrize("ns,D,levels", [
    ((2,), 4, 2), ((3,), 4, 2), ((33,), 8, 2),        # most blocks own no rows
    ((33, 2, 3), 8, 1),                                # levels 1: many ties
    ((200,), 16, 1), ((517, 64), 16, 2)])
def test_nn_chain_kernel_bit_equal_to_twin_on_exact_dots(ns, D, levels,
                                                         blocks_per_sm):
    """On integer rows (exact dots: the kernel and the twin break the same
    exact ties), the kernel's merges, distances, steps and rows equal the
    twin's bit for bit, at one and two blocks an SM. N = 2, 3 and 33 leave
    most of the grid's blocks without rows; entries in [-1, 1] make many
    rows and cluster sums tie exactly, so the lowest-index and predecessor
    rules decide most steps."""
    _need_card()
    from vbx_tpu_torch.clustering import device as cdev

    sums = _integer_walk_inputs(ns, D, seed=sum(ns) + D, levels=levels)
    k_out = cdev.nn_chain_walk(sums.cuda(), ns, blocks_per_sm=blocks_per_sm)
    _assert_walks_equal(k_out, cdev.nn_chain_walk_plain(sums, ns), ns)


@pytest.mark.gpu
@pytest.mark.parametrize("blocks_per_sm", [1, 2])
def test_nn_chain_kernel_reads_the_row_it_merged_in_the_same_step(
        blocks_per_sm):
    """The trap of the owner's merge: a merge that empties the chain seeds
    it with the lowest active index, which is the row b written in that very
    step. Built on purpose: row 0 is duplicated as row 5 and every other row
    is farther from it, so the walk pushes 5 onto the chain [0], merges 5
    into 0 (chain empty) and seeds the chain with 0, whose new sum the next
    step must see (a stale row would halve every distance to it). Rows
    1 / 9 and 2 / 12 are such pairs as well. The twin (integer rows, exact
    dots) is the reference, bit for bit."""
    _need_card()
    from vbx_tpu_torch.clustering import device as cdev

    D, n = 16, 40
    rng = np.random.default_rng(17)
    x = rng.integers(-1, 2, (n, D)).astype(np.float64)
    for i, j in ((0, 5), (1, 9), (2, 12)):
        x[i] = 3.0 * rng.integers(-1, 2, D)
        x[i, i] = 4.0                     # pairs far from each other
        x[j] = x[i]
    sums = torch.from_numpy(x)[None]
    p_out = cdev.nn_chain_walk_plain(sums, [n])
    assert (int(p_out[0][0, 0]), int(p_out[1][0, 0])) == (5, 0)
    k_out = cdev.nn_chain_walk(sums.cuda(), [n], blocks_per_sm=blocks_per_sm)
    _assert_walks_equal(k_out, p_out, [n])


@pytest.mark.gpu
def test_nn_chain_kernel_more_lanes_than_blocks_with_rows():
    """40 lanes of 2-60 rows in one launch (more lanes than the blocks that
    own rows, and more than the kernel walks at once: two groups), each
    lane bit-equal to the twin and to itself alone."""
    _need_card()
    from vbx_tpu_torch.clustering import device as cdev

    ns = [2 + (7 * m) % 59 for m in range(40)]
    sums = _integer_walk_inputs(ns, 8, seed=23)
    before = cdev.nn_chain_walk.launches
    k_out = cdev.nn_chain_walk(sums.cuda(), ns)
    assert cdev.nn_chain_walk.launches == before + 1
    assert cdev.nn_chain_walk.group < len(ns)
    _assert_walks_equal(k_out, cdev.nn_chain_walk_plain(sums, ns), ns)
    for m in (0, 17, 39):
        n = ns[m]
        alone = cdev.nn_chain_walk(sums[m:m + 1, :n].cuda().contiguous(), [n])
        for j in range(3):
            assert torch.equal(alone[j][0, :n - 1], k_out[j][m, :n - 1])


@pytest.mark.gpu
def test_linkage_on_a_card_matches_the_host_chain():
    """linkage_dot_avg_device on the card against the float64 host chain:
    sorted distances within 1e-12 (tests/test_clustering.py's contract is
    1e-6, for a float32 walk), the host's merges, labels equal at
    gap-midpoint cuts; and the 'auto' AHC route launches the walk and
    gives the host route's labels."""
    _need_card()
    from vbx_tpu_torch.clustering import device as cdev, linkage_dot_avg
    from vbx_tpu_torch.engine import ahc

    _, xs = _walk_inputs((6500,), 64, seed=5, K=6)
    xn = xs[0]
    Zh = linkage_dot_avg(xn)
    Zd = cdev.linkage_dot_avg_device(xn, device="cuda")
    assert np.abs(np.sort(Zh[:, 2]) - np.sort(Zd[:, 2])).max() < 1e-12
    np.testing.assert_array_equal(Zd[:, :2], Zh[:, :2])
    for ld, lh in _labels_at_cuts(Zd, Zh, len(xn)):
        np.testing.assert_array_equal(ld, lh)
    before = cdev.nn_chain_walk.launches
    auto = ahc.ahc_labels(xn, 0.0, compute_backend="auto", device="cuda")
    assert cdev.nn_chain_walk.launches == before + 1
    host = ahc.ahc_labels(xn, 0.0, compute_backend="host", device="cuda")
    np.testing.assert_array_equal(auto, host)


@pytest.mark.gpu
def test_cosine_sweep_on_a_card_matches_the_host():
    """two_gmm_calib_cosine_device and _batched on the card against the
    host float64 blocked sweep, tests/test_ahc.py's bar (5e-5)."""
    _need_card()
    from vbx_tpu_torch.engine.ahc import _blocked_cosine_condensed_and_thr
    from vbx_tpu_torch.ops.calibration import (
        two_gmm_calib_cosine_device, two_gmm_calib_cosine_device_batched)

    _, xs = _walk_inputs((4500, 2100, 900), 24, seed=11, K=4)
    thr_b = two_gmm_calib_cosine_device_batched(xs, device="cuda")
    for m, xn in enumerate(xs):
        _, thr_h = _blocked_cosine_condensed_and_thr(xn,
                                                     want_condensed=False)
        thr_d = two_gmm_calib_cosine_device(xn, device="cuda")
        assert abs(thr_d - thr_h) < 5e-5, (m, thr_d, thr_h)
        assert abs(thr_b[m] - thr_h) < 5e-5, (m, thr_b[m], thr_h)


@pytest.mark.gpu
def test_service_on_a_card_matches_the_offline_pipeline(tmp_path):
    """DiarizationService(device='cuda') on a small synthetic corpus: the
    same labels as diarize_ark on the card (a recording's result does not
    depend on its batch), K1 launched."""
    _need_card()
    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.engine.pipeline import diarize_ark
    from vbx_tpu_torch.io.ark import read_vec_ark_grouped
    from vbx_tpu_torch.io.segments import read_xvector_timing_dict
    from vbx_tpu_torch.serving import DiarizationService
    from vbx_tpu_torch.testing import write_corpus

    c = write_corpus(str(tmp_path), 1, [300, 520, 700, 410, 260, 900],
                     [2, 4, 3, 5, 2, 4])
    cfg = get_preset("example")
    off = diarize_ark(c["ark"], c["segments"], str(tmp_path / "off"), cfg,
                      c["plda"], c["transform"], fb_impl="pallas",
                      verbose=False, device="cuda")
    segs = read_xvector_timing_dict(c["segments"])
    before = fb_kernel.fb_fused_sb.launches
    with DiarizationService.from_files(cfg, c["plda"], c["transform"],
                                       device="cuda",
                                       batch_window_ms=200.0) as svc:
        assert svc._fb_impl is None
        futs = {rec: svc.submit(rec, x, segs[rec][1])
                for rec, _, x in read_vec_ark_grouped(c["ark"])}
        res = {rec: f.result(timeout=300) for rec, f in futs.items()}
    with DiarizationService.from_files(cfg, c["plda"], c["transform"],
                                       device="cuda", fb_impl="pallas",
                                       batch_window_ms=200.0) as svc:
        futs = {rec: svc.submit(rec, x, segs[rec][1])
                for rec, _, x in read_vec_ark_grouped(c["ark"])}
        res_k = {rec: f.result(timeout=300) for rec, f in futs.items()}
    assert fb_kernel.fb_fused_sb.launches > before
    for rec in off:
        np.testing.assert_array_equal(res_k[rec].labels1st,
                                      off[rec].labels1st)
        assert res[rec].n_speakers >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("fb_impl", ["pallas", "pallas_bf16"])
def test_bench_device_passes_the_guard_on_a_card(fb_impl):
    """bench_torch.py's VB stage at B=8 on the card: 5 surviving
    speakers, the truth on the main speakers' frames, every lane equal to
    lane 0, and K1 launched in the timed runs."""
    _need_card()
    import bench_torch
    from vbx_tpu_torch.config import get_preset

    cfg = get_preset("example")
    fea, phi, qinit, truth = bench_torch.prepare_inputs(cfg, "cuda")
    r = bench_torch.bench_device(fea, phi, qinit, bench_torch.vb_hp(cfg),
                                 fb_impl, truth, B=8, repeats=2)
    assert r["guard"]["ok"], r["guard"]
    assert r["k1_launches"] >= 2 * r["iters"] > 0


def _driver(name):
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_gpu_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("name,argv", [
    ("torch_serving_bench", ["8", "2"]),
    ("torch_extractor_bench", ["0.1"]),
    ("torch_ami_scale_bench", ["--n-meetings", "1", "--frames", "300",
                               "600", "--check-meetings", "1"]),
    ("torch_linkage_scale_bench", ["2000"]),
    ("torch_linkage_scale_bench", ["2000", "--ondemand"]),
    ("torch_scaling_bench", ["--T", "256", "--reps", "1"])])
def test_measurement_driver_on_a_card(name, argv, capsys, monkeypatch):
    """Each scripts/torch_*_bench.py driver at its smallest size on the
    card: it exits 0 (its own checks included) and its JSON line names
    the card it measured on."""
    _need_card()
    import json

    monkeypatch.setenv("SCALING_DEVICES", "2")
    assert _driver(name).main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] != "cpu", line
