"""The arithmetic and the index code of the CUDA kernels K1 (csrc/
fb_fused_sb.cu) and K2 (csrc/fb_fwd_product_sb.cu), emulated in plain torch
on the CPU and held to the kernels' plain twins.

The kernels only run on a card (tests/test_torch_gpu.py, chip_smoke.py).
What can be wrong in their design without a card to show it is checked
here: the per-frame sums taken in the kernels' order (speaker s = g + G k
of thread g, a tree over k, then a shuffle butterfly over the G threads of
the group), for every (G, P) instance; the backward chain's merged
normalizer lp * sum(u) + S * sum(col u), with absent speakers on a lane;
a reciprocal that is off by one or two ulp, as the hardware approximation
may be; frames whose sum lies under the 1e-37 floor; skip_dead with leading
and all-dead frames; K2's logarithm taken from exponents and mantissa
products; and the arithmetic of the 16-byte-aligned runs that stage w
through shared memory, which must cover every chunk and never leave the
tensor. The Python mirrors of the kernels' host functions are checked
against the constants and the instance lists in the sources, and the
texts that scripts/torch_fb_fused_tuning.py replaces to make its variants
must still be found in them.

Bars: the card bars of tests/test_torch_gpu.py and chip_smoke.py. K1 ahat,
per-frame-normalized bhat and gamma 2e-5, cfw and log_px 1e-5 relative in
float32 (the emulation and the twin differ in summation order, fused
multiply-adds and the reciprocal's last bits); 8e-3 / 2e-3 with bfloat16
streams. K2 fhat relative to its row's max and ls relative to max(1, |ls|)
4e-6.
"""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from vbx_tpu_torch.ops import fb_kernel
from vbx_tpu_torch.ops import fb_product_kernel as k2

CSRC = os.path.join(os.path.dirname(os.path.abspath(fb_kernel.__file__)),
                    os.pardir, "csrc")
TINY, HUGE = 1e-37, 1e30
BARS = {"float32": (2e-5, 1e-5), "bfloat16": (8e-3, 2e-3)}
K2_BAR = 4e-6
F32 = torch.float32


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", _source("fb_step.cuh"))
    return int(m.group(1))


# ---- mirrors of the kernels' host functions (fb_step.cuh) -----------------

def pick_group(S):
    P = 4 if S <= 128 else 8
    G = 1
    while G * P < S:
        G *= 2
    return G, P


def pick_log_chunk(frame_bytes):
    chunk, lo, hi = (_constant(n) for n in (
        "kChunkBytes", "kMinChunkFrames", "kMaxChunkFrames"))
    log_f = 0
    while (2 << log_f) * frame_bytes <= chunk:
        log_f += 1
    return min(max(log_f, lo.bit_length() - 1), hi.bit_length() - 1)


def ring_pad_bytes(frame_bytes):
    return (frame_bytes + 15) // 16 * 16


def ring_stride_bytes(chunk_bytes, frame_bytes, G):
    words = ((chunk_bytes + 15) // 16 * 16 + 16
             + 2 * ring_pad_bytes(frame_bytes)) // 4
    want = (4 if G < 4 else G) % 32
    while words % 32 != want:
        words += 4
    return words * 4


def staged_run(lo, hi, s, e, esize):
    """stage_bytes' plan for the chunk [s, e) of a tensor at [lo, hi):
    (r0, the source addresses of the 16-byte pieces of the one bulk copy
    [v0, v1), single elements' addresses)."""
    r0, r1 = s & ~15, (e + 15) & ~15
    v0 = r0 + 16 if r0 < lo else r0
    v1 = r1 - 16 if r1 > hi else r1
    vectors = list(range(v0, v1, 16))
    singles = []
    if r0 < lo:
        singles += list(range(s, min(v0, e), esize))
    if r1 > hi:
        singles += list(range(max(v1, s), e, esize))
    return r0, vectors, singles


# ---- the staging's index arithmetic ---------------------------------------

@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("base_elements", [0, 1, 2, 3, 5, 7])
@pytest.mark.parametrize("B,T,S", [(3, 1025, 31), (5, 7, 3), (2, 1, 1),
                                   (4, 33, 9), (1, 2, 5), (2, 130, 33)])
def test_staged_runs_cover_every_chunk_and_stay_inside(esize, base_elements,
                                                       B, T, S):
    """Every (lane, chunk): the copies read only bytes of the tensor, the
    bulk copy with source, destination and size multiples of 16, everything
    lands inside the ring buffer, and reading the chunk back from the
    buffer at offset (s & 15) returns the chunk. The tensor starts
    base_elements past a 16-byte boundary (a view into a larger one)."""
    n_bytes = B * T * S * esize
    lo = 512 + base_elements * esize
    hi = lo + n_bytes
    rng = np.random.default_rng(B * T * S + esize)
    memory = np.zeros(hi + 64, np.uint8)          # bytes outside stay 0
    memory[lo:hi] = rng.integers(1, 256, n_bytes, dtype=np.uint8)
    frame_bytes = S * esize
    log_f = pick_log_chunk(frame_bytes)
    front = ring_pad_bytes(frame_bytes)
    stride = ring_stride_bytes(frame_bytes << log_f, frame_bytes, 8)
    assert stride % 16 == 0
    n_chunks = (T + (1 << log_f) - 1) >> log_f
    for b in range(B):
        first = lo + b * T * frame_bytes
        for c in range(n_chunks):
            s = first + (c << log_f) * frame_bytes
            e = first + min((c + 1) << log_f, T) * frame_bytes
            r0, vectors, singles = staged_run(lo, hi, s, e, esize)
            buf = np.zeros(stride, np.uint8)
            for a in vectors:
                assert a % 16 == 0 and lo <= a and a + 16 <= hi
                d = front + a - r0
                assert d % 16 == 0 and 0 <= d and d + 16 <= stride
                buf[d:d + 16] = memory[a:a + 16]
            for a in singles:
                assert s <= a and a + esize <= e
                d = front + a - r0
                buf[d:d + esize] = memory[a:a + esize]
            off = front + (s & 15)
            np.testing.assert_array_equal(buf[off:off + e - s], memory[s:e])
            # the step reads one frame past either end of the chunk
            assert off - frame_bytes >= 0
            assert off + (e - s) + frame_bytes <= stride


@pytest.mark.parametrize("esize", [2, 4])
def test_group_and_ring_choices_fit_the_card(esize):
    """For every S the narrow form takes: G a power of two <= 32 with
    G * P >= S and no smaller G doing, the instance exists in both sources,
    and the ring of a block fits the card's shared memory."""
    pairs = {name: {(int(g), int(p)) for g, p in re.findall(
        rf"^  {macro}\((\d+), (\d+)\)$", _source(name), re.M)}
        for name, macro in (("fb_fused_sb.cu", "FB_NARROW"),
                            ("fb_fwd_product_sb.cu", "FB_GROUP"))}
    stages = _constant("kStages")
    for S in range(1, 257):
        G, P = pick_group(S)
        assert G in (1, 2, 4, 8, 16, 32) and G * P >= S
        assert G == 1 or (G // 2) * P < S
        assert (G, P) in pairs["fb_fused_sb.cu"]
        if S <= k2.S_MAX:
            assert (G, P) in pairs["fb_fwd_product_sb.cu"]
        frame_bytes = S * esize
        log_f = pick_log_chunk(frame_bytes)
        assert 2 <= log_f <= 7
        stride = ring_stride_bytes(frame_bytes << log_f, frame_bytes, G)
        # the rings and the mbarriers of a warp's lanes
        assert (32 // G) * stages * (stride + 8) <= 227 * 1024
    assert pick_group(31) == (8, 4) and pick_group(8) == (2, 4)


# ---- the step's arithmetic ------------------------------------------------

def _fma(a, b, c):
    """float32 fused multiply-add: the product is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def _group_sums(*vals):
    """The kernels' per-lane sums of [..., S] float32 values: speaker
    s = g + G k of thread g, a tree over k (t[k] += t[k + h], h = P/2 ..
    1), then the butterfly over g (offsets G/2 .. 1). One result per
    input, each [..., 1]."""
    S = vals[0].shape[-1]
    G, P = pick_group(S)
    out = []
    for v in vals:
        pad = torch.zeros(v.shape[:-1] + (G * P - S,), dtype=F32)
        t = torch.cat([v, pad], -1).reshape(v.shape[:-1] + (P, G))
        h = P // 2
        while h:
            t = t[..., :h, :] + t[..., h:2 * h, :]
            h //= 2
        t = t[..., 0, :]
        o = G // 2
        idx = torch.arange(G)
        while o:
            t = t + t[..., idx ^ o]
            o //= 2
        out.append(t[..., :1])
    return out


def _recip(c_raw, floor_exact, ulps):
    """norm_recip: 1 / max(c_raw, 1e-37), moved by `ulps` float32 steps
    where the kernel takes the hardware approximation."""
    c = torch.clamp(c_raw, min=TINY)
    exact = 1.0 / c
    r = exact
    for _ in range(abs(ulps)):
        r = torch.nextafter(r, torch.full_like(r, np.inf if ulps > 0 else 0))
    rare = c_raw >= HUGE
    if floor_exact:
        rare = rare | ~(c_raw > TINY)
    return torch.where(rare, exact, r)


def _normalize(a, c_raw, carry, recip, skip_dead, ulps):
    dead = ~(c_raw > TINY) if skip_dead else torch.zeros_like(c_raw, dtype=bool)
    c = torch.clamp(c_raw, min=TINY)
    new = a * _recip(c_raw, not skip_dead, ulps) if recip else a / c
    return torch.where(dead, carry, new), torch.where(
        dead, torch.ones_like(c), c)


def emulate_k1(w, col, pinit, binit, lp, recip, skip_dead, ulps=0):
    """The narrow kernel's walk (fb_fused_narrow_kernel), all lanes at
    once."""
    B, T, S = w.shape
    lp = torch.tensor(lp, dtype=F32)
    ahat, bhat = torch.empty_like(w), torch.empty_like(w)
    cfw = torch.empty((B, T), dtype=F32)
    x, carry = pinit, torch.zeros((B, S), dtype=F32)
    for t in range(T):
        a = w[:, t].float() * x
        (c_raw,) = _group_sums(a)
        carry, c = _normalize(a, c_raw, carry, recip, skip_dead, ulps)
        ahat[:, t], cfw[:, t] = carry.to(w.dtype), c[:, 0]
        x = _fma(lp, carry, col)
    carry = binit
    bhat[:, T - 1] = binit.to(w.dtype)
    s_f = torch.tensor(float(S), dtype=F32)
    for f in range(T - 1, 0, -1):
        u = w[:, f].float() * carry
        su, cu = _group_sums(u, col * u)
        cb_raw = _fma(lp, su, s_f * cu)
        carry, _ = _normalize(_fma(lp, u, cu), cb_raw, carry, recip,
                              skip_dead, -ulps)
        bhat[:, f - 1] = carry.to(w.dtype)
    return ahat, bhat, cfw


def _k1_case(B, T, S, io, seed, skip_dead=False, floor=False):
    """Emission weights with max 1 per frame; lane 1's last two speakers
    absent (w exactly 0, priors 0) where S > 2; with skip_dead lane 0
    starts with dead frames, the last lane is all dead and a random
    boundary message starts the backward chain; with floor two of lane 0's
    frames are scaled by 1e-38, so that their sums lie under 1e-37 (more
    such frames in a row and the messages underflow to zero for good)."""
    rng = np.random.default_rng(seed)
    log_p = 3.0 * rng.standard_normal((B, T, S)) - 30
    w = np.exp(log_p - log_p.max(-1, keepdims=True)).astype(np.float32)
    pi = rng.uniform(size=(B, S)).astype(np.float32)
    if S > 2 and B > 1:
        w[1, :, -2:] = 0.0
        pi[1, -2:] = 0.0
    pi /= pi.sum(-1, keepdims=True)
    binit = np.full((B, S), 1.0 / S, np.float32)
    if skip_dead:
        w[0, :min(5, T - 1)] = 0.0
        w[0, T // 2:T // 2 + 3] = 0.0
        w[B - 1] = 0.0
        binit = rng.uniform(0.05, 1.05, size=(B, S)).astype(np.float32)
        binit /= binit.sum(-1, keepdims=True)
    if floor:
        w[0, T // 3:T // 3 + 2] *= np.float32(1e-38)
    lp = 0.99
    t = torch.as_tensor
    return (t(w).to(io), t((1 - lp) * pi + 1e-8).float(),
            t(pi + 1e-8).float(), t(binit), lp)


def _assert_k1_close(got, ref, w, io_name):
    gtol, ltol = BARS[io_name]
    (ak, bk, ck), (ap, bp, cp) = ([x.float() for x in y] for y in (got, ref))
    torch.testing.assert_close(ak, ap, atol=gtol, rtol=0)

    def norm(b):
        return b / b.sum(-1, keepdim=True)

    torch.testing.assert_close(norm(bk), norm(bp), atol=gtol, rtol=0)
    torch.testing.assert_close(ck, cp, rtol=ltol, atol=0)

    def gamma(a, b):
        ab = a * b
        return ab / ab.sum(-1, keepdim=True).clamp(min=1e-37)

    torch.testing.assert_close(gamma(ak, bk), gamma(ap, bp), atol=gtol,
                               rtol=0)
    lk, lpx = torch.log(ck).sum(1), torch.log(cp).sum(1)
    assert float(((lk - lpx).abs() / lpx.abs().clamp(min=1.0)).max()) <= ltol


# S: every (G, P) instance with a full and a ragged group
@pytest.mark.parametrize("S", [1, 2, 3, 4, 8, 9, 16, 31, 33, 64, 100, 128,
                               200, 256])
@pytest.mark.parametrize("io_name", ["float32", "bfloat16"])
def test_k1_grouped_sums_and_merged_backward_sum(S, io_name):
    args = _k1_case(3, 40, S, getattr(torch, io_name), seed=S)
    got = emulate_k1(*args, recip=True, skip_dead=False)
    ref = fb_kernel.fb_fused_sb_plain(*args, recip=True, skip_dead=False)
    _assert_k1_close(got, ref, args[0], io_name)


@pytest.mark.parametrize("ulps", [-2, -1, 1, 2])
@pytest.mark.parametrize("S", [8, 31])
def test_k1_reciprocal_off_by_ulps(ulps, S):
    args = _k1_case(4, 300, S, torch.float32, seed=10 + S)
    got = emulate_k1(*args, recip=True, skip_dead=False, ulps=ulps)
    ref = fb_kernel.fb_fused_sb_plain(*args, recip=True, skip_dead=False)
    _assert_k1_close(got, ref, args[0], "float32")


@pytest.mark.parametrize("recip", [True, False])
@pytest.mark.parametrize("io_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 2, 3, 60])
def test_k1_skip_dead_leading_and_all_dead(T, io_name, recip):
    """Dead frames keep the carry and record c = 1 exactly; an all-dead
    lane returns zeros forward and its boundary message backward."""
    args = _k1_case(3, T, 9, getattr(torch, io_name), seed=T, skip_dead=True)
    got = emulate_k1(*args, recip=recip, skip_dead=True, ulps=1)
    ref = fb_kernel.fb_fused_sb_plain(*args, recip=recip, skip_dead=True)
    w = args[0].float()
    dead = w.sum(-1) == 0
    assert torch.all(got[2][dead] == 1.0) and torch.all(ref[2][dead] == 1.0)
    assert torch.all(got[0][-1] == 0) and torch.equal(
        got[1][-1].float(), args[3][-1].to(args[0].dtype).float().expand(
            T, -1))
    ok = ~dead
    torch.testing.assert_close(got[0].float()[ok], ref[0].float()[ok],
                               atol=BARS[io_name][0], rtol=0)
    torch.testing.assert_close(got[2][ok], ref[2][ok], rtol=BARS[io_name][1],
                               atol=0)
    nb = [b.float() / b.float().sum(-1, keepdim=True).clamp(min=1e-37)
          for b in (got[1], ref[1])]
    torch.testing.assert_close(nb[0][:-1], nb[1][:-1], atol=BARS[io_name][0],
                               rtol=0)


@pytest.mark.parametrize("skip_dead", [False, True])
@pytest.mark.parametrize("io_name", ["float32", "bfloat16"])
def test_k1_frames_under_the_floor(io_name, skip_dead):
    """Frames whose sum is under 1e-37: without skip_dead the floor divides
    (the exact path: c = 1e-37 recorded, the reciprocal not perturbed);
    with skip_dead they are skipped."""
    io = getattr(torch, io_name)
    args = _k1_case(2, 60, 8, io, seed=3, floor=True)
    w = args[0]
    assert float(w[0, 20:22].float().sum(-1).max()) < 1e-37
    got = emulate_k1(*args, recip=True, skip_dead=skip_dead, ulps=2)
    ref = fb_kernel.fb_fused_sb_plain(*args, recip=True, skip_dead=skip_dead)
    floor_c = torch.tensor(1.0 if skip_dead else TINY, dtype=F32)
    assert torch.all(got[2][0, 20:22] == floor_c)
    assert torch.all(ref[2][0, 20:22] == floor_c)
    _assert_k1_close(got, ref, w, io_name)


# ---- K2 ---------------------------------------------------------------------

def emulate_k2(w, col, finit, lp):
    """fwd_product_kernel's walk: grouped sums, skipped frames as selects,
    ls from the sum of exponents and float64-summed logs of mantissa
    products (one logf per chunk once 32 frames have gone by)."""
    B, Tb, S = w.shape
    R = finit.shape[0]
    Ts = Tb // R
    lp = torch.tensor(lp, dtype=F32)
    log_f = min(pick_log_chunk(S * w.element_size()), 6)
    wseg = w.view(B, R, Ts, S).permute(1, 0, 2, 3).float()
    colr = col[None, :, None, :]
    carry, x = finit.clone(), finit.clone()
    esum = torch.zeros((R, B, S, 1), dtype=torch.int64)
    mprod = torch.ones((R, B, S, 1), dtype=F32)
    mlog = torch.zeros((R, B, S, 1), dtype=torch.float64)
    since = 0
    for t in range(Ts):
        a = wseg[:, :, t][:, :, None, :] * x
        (c,) = _group_sums(a)
        live = c > TINY
        rc = _recip(c, False, 1 if t % 2 else -1)   # an ulp off, either way
        bits = c.view(torch.int32).long()
        esum += torch.where(live, bits >> 23, torch.full_like(bits, 127))
        mant = ((bits & 0x007fffff) | 0x3f800000).int().view(F32)
        mprod = mprod * torch.where(live, mant, torch.ones_like(mant))
        carry = torch.where(live, a * rc, carry)
        x = _fma(lp, carry, colr.expand_as(carry))
        since += 1
        end_of_chunk = (t + 1) % (1 << log_f) == 0 or t == Ts - 1
        if end_of_chunk and since >= 32:
            assert since < 96
            mlog += torch.log(mprod).double()
            mprod = torch.ones_like(mprod)
            since = 0
    ls = ((esum - 127 * Ts).double() * float(np.log(2.0)) + mlog
          + torch.log(mprod).double()).float()
    return carry, ls[..., 0]


@pytest.mark.parametrize("io_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Tb,S,R", [(2, 256, 8, 4), (2, 1200, 8, 2),
                                      (3, 90, 1, 3), (2, 64, 31, 2),
                                      (1, 40, 33, 4), (2, 48, 128, 2),
                                      (2, 36, 100, 3)])
def test_k2_grouped_sums_skips_and_log_from_exponents(io_name, B, Tb, S, R):
    """Against the twin inside the card bar: lane 0's last speaker absent,
    the last lane ending in dead frames (a partly dead and, with R >= 3,
    a wholly dead segment, which must return finit and ls = 0 exactly),
    and, in the long case, sums just under 1 for hundreds of frames (the
    exponents' and the mantissas' logs nearly cancel)."""
    rng = np.random.default_rng(Tb + S)
    w = rng.uniform(size=(B, Tb, S)).astype(np.float32)
    if Tb > 1000:
        w = (0.97 + 0.02 * w).astype(np.float32)   # c just under 1
    if S > 1:
        w[0, :, -1] = 0.0
    Ts = Tb // R
    w[B - 1, Tb - Ts - Ts // 3:] = 0.0
    pi = rng.uniform(size=(B, S)).astype(np.float32)
    lp = 0.99
    col = torch.as_tensor((1 - lp) * pi / pi.sum(-1, keepdims=True) + 1e-8)
    w = torch.as_tensor(w).to(getattr(torch, io_name))
    eye = torch.eye(S)
    finit = (lp * eye + col[:, None, :]).expand(R, B, S, S).clone()
    finit[0] = eye
    fk, lk = emulate_k2(w, col, finit, lp)
    fp, lpl = k2.fb_fwd_product_sb_plain(w, col, finit, lp)
    rowmax = fp.abs().amax(-1, keepdim=True)
    assert float(((fk - fp).abs() / rowmax).max()) <= K2_BAR
    assert float(((lk - lpl).abs() / lpl.abs().clamp(min=1.0)).max()) <= K2_BAR
    assert torch.equal(fk[R - 1, B - 1], finit[R - 1, B - 1])
    assert torch.all(lk[R - 1, B - 1] == 0)


# ---- the scripts beside the kernels -----------------------------------------

def _load(path):
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROOT = os.path.join(CSRC, os.pardir, os.pardir)
TUNING = _load(os.path.join(ROOT, "scripts", "torch_fb_fused_tuning.py"))


@pytest.mark.parametrize("source,tag", [
    (name, tag) for name, variants in (
        ("fb_fused_sb.cu", TUNING.K1_VARIANTS),
        ("fb_fwd_product_sb.cu", TUNING.K2_VARIANTS)) for tag in variants])
def test_tuning_variants_still_address_the_shipped_sources(source, tag):
    """Every text the tuning script replaces is found in the shipped source
    or header (it raises on the card otherwise), and every variant but
    'shipped' changes one of them."""
    variants = (TUNING.K1_VARIANTS if source == "fb_fused_sb.cu"
                else TUNING.K2_VARIANTS)
    src_subs, header_subs = variants[tag]
    src, header = _source(source), _source("fb_step.cuh")
    changed = (TUNING.variant_source(src, src_subs) != src
               or TUNING.variant_source(header, header_subs) != header)
    assert changed == (tag != "shipped")


@pytest.mark.parametrize("esize", [2, 4])
def test_kernel_bounds_script_agrees_with_chip_smoke(esize):
    """scripts/kernel_bounds.py (from the shapes alone) and chip_smoke.py
    (from its run's inputs) state the same K1, K2 and K3-K5 bounds; K1's at
    the bench shape is its bytes over 3.35 TB/s."""
    bounds = _load(os.path.join(ROOT, "scripts", "kernel_bounds.py"))
    smoke = _load(os.path.join(ROOT, "chip_smoke.py"))
    for shape in bounds.K1_SHAPES:
        assert bounds.k1_bound(*shape, esize) == smoke.k1_bound(*shape, esize)
    assert bounds.K1_SHAPES == (
        (smoke.BENCH["B"], smoke.BENCH["T"], smoke.BENCH["S"]),
        (smoke.LONG["B"], smoke.LONG["T"], smoke.LONG["S"]))
    assert bounds.K2_SHAPES == tuple(s[1:] for s in smoke.K2_SHAPES)
    for shape in bounds.K2_SHAPES:
        assert bounds.k2_bound(*shape, esize) == smoke.k2_bound(*shape, esize)
    # K3-K5 (float32 walks: the same bounds for either esize case)
    for T, S, B in bounds.SHAPES:
        for kernel in bounds.SCAN_KERNELS:
            assert bounds.scan_bound(T, B, S, kernel) == \
                smoke.scan_bound(T, B, S, kernel)
    assert (bounds.SHAPES[-1][0], bounds.SHAPES[-1][2],
            bounds.SHAPES[-1][1]) == smoke.SCAN_SHAPES[0][1:4]
    assert bounds.scan_bound(1025, 256, 31, "fb_scan_fused")["bytes"] == \
        3 * 1025 * 256 * 31 * 4 + 2 * 256 * 31 * 4
    b = bounds.k1_bound(256, 1025, 31, esize)
    assert b["bound_by"] == "bytes"
    assert b["bytes"] == 3 * 256 * 1025 * 31 * esize + 256 * 1025 * 4 \
        + 3 * 256 * 31 * 4
    assert abs(b["bound_ms"] - b["bytes"] / 3.35e12 * 1e3) < 1e-12
