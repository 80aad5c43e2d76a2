"""The arithmetic and the index code of the CUDA kernels K3, K4 and K5
(csrc/fb_scan_tbs.cu: fb_scan_fused_kernel, fb_scan_fwd_kernel,
fb_scan_bwd_kernel), emulated in plain torch on the CPU and held to their
plain twins and to vbx_tpu's fb_scan_pallas in interpret mode.

The kernels only run on a card (tests/test_torch_gpu.py, chip_smoke.py).
What can be wrong in their design without a card to show it is checked
here: the per-frame sums taken in the kernels' order (speaker s = g + G k
of thread g, a tree over k, then a shuffle butterfly over the G threads of
the group), for every (G, P) instance; the backward chain's merged
normalizer lp * sum(u) + S * sum(col u), with absent speakers on a lane;
K4's c_t, the floored forward sum; a reciprocal that is off by one or two ulp, as the hardware approximation
may be; frames whose sum lies under the 1e-37 floor; and the row ring that
stages w through shared memory (fb_step.cuh: RowStager): every row of every
chunk lands whole and is read back by every lane of the warp, in both walk
directions, no copy leaves the tensor or its buffer, and the step's moving
read pointer meets each frame in turn. The Python mirrors of the kernels'
host functions are checked against the constants and the instance list in
the sources, and the texts that scripts/torch_fb_scan_tuning.py replaces
to make its variants must still be found in them.

Bars: the card bars of tests/test_torch_gpu.py and chip_smoke.py (SCAN_BARS):
ahat and per-frame-normalized bhat 2e-5 absolute, cfw 1e-5 relative, on
valid frames (the emulation and the twin differ in summation order, fused
multiply-adds and the reciprocal's last bits).
"""

import importlib.util
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbx_tpu.ops.fb_pallas import fb_scan_pallas
from vbx_tpu_torch.ops import fb_scan_kernel as fbs

from .test_torch_fb_kernel_design import (
    CSRC, ROOT, TINY, _constant, _fma, _group_sums, _recip, pick_group,
    pick_log_chunk, staged_run)
from .test_torch_fb_scan import _problem

AHAT_BAR = BHAT_BAR = 2e-5
CFW_REL_BAR = 1e-5
F32 = torch.float32


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


# ---- the step's arithmetic ------------------------------------------------

def emulate_scan(w, col, pinit, lp, ulps=0, forward=True, backward=True):
    """K3's two chains (K4 is the forward one, K5 the backward one) over
    [T, B, S] float32 weights, all lanes at once: grouped sums, the
    reciprocal moved by `ulps` (the other way backward) except at the floor
    and above 1e30, K4's cfw = max(group sum, 1e-37), the merged backward
    normalizer. Returns (ahat, bhat, cfw [T, B]); what a chain not asked for
    gives is None."""
    T, B, S = w.shape
    lp = torch.tensor(lp, dtype=F32)
    ahat = bhat = cfw = None
    if forward:
        ahat = torch.empty_like(w)
        cfw = torch.empty((T, B), dtype=F32)
        x = pinit
        for t in range(T):
            a = w[t] * x
            (c_raw,) = _group_sums(a)
            carry = a * _recip(c_raw, True, ulps)
            ahat[t] = carry
            cfw[t] = torch.clamp(c_raw, min=TINY)[:, 0]
            x = _fma(lp, carry, col)
    if backward:
        bhat = torch.empty_like(w)
        s_f = torch.tensor(float(S), dtype=F32)
        carry = torch.full((B, S), 1.0, dtype=F32) / s_f
        bhat[T - 1] = carry
        for f in range(T - 1, 0, -1):
            u = w[f] * carry
            su, cu = _group_sums(u, col * u)
            r = _recip(_fma(lp, su, s_f * cu), True, -ulps)
            carry = _fma(lp, u, cu) * r
            bhat[f - 1] = carry
    return ahat, bhat, cfw


def _norm(b):
    return b / b.sum(-1, keepdim=True)


def _case(T, B, S, seed, floor=False):
    """Filled [T, B, S] weights as fb_scan hands them to its kernels (max 1
    per frame), lane 0's last two speakers absent (w and prior 0) where
    S > 2, the last lane ending in a padded suffix of 1/S; with floor two
    frames of lane 0 scaled by 1e-38, so that (S <= 9) their sums lie
    under 1e-37."""
    rng = np.random.default_rng(seed)
    log_p = 3.0 * rng.standard_normal((T, B, S)) - 30
    w = np.exp(log_p - log_p.max(-1, keepdims=True)).astype(np.float32)
    pi = rng.uniform(size=(B, S)).astype(np.float32)
    if S > 2:
        w[:, 0, -2:] = 0.0
        pi[0, -2:] = 0.0
    pi /= pi.sum(-1, keepdims=True)
    valid = np.ones((T, B), bool)
    if B > 1 and T > 4:
        valid[T - T // 4:, B - 1] = False
        w[~valid] = np.float32(1.0 / S)
    if floor:
        w[T // 3:T // 3 + 2, 0] *= np.float32(1e-38)
    lp = 0.9
    t = torch.as_tensor
    return (t(w), t((1 - lp) * pi + 1e-8).float(), t(pi + 1e-8).float(),
            lp, t(valid))


def _assert_close(got, ref, valid, name):
    err = float((got - ref).abs()[valid].max())
    bar = AHAT_BAR if name == "ahat" else BHAT_BAR
    assert err <= bar, f"{name} off by {err:.3g} > {bar}"


def _assert_cfw_close(got, ref, valid):
    err = float(((got - ref).abs() / ref)[valid].max())
    assert err <= CFW_REL_BAR, f"cfw off by {err:.3g} > {CFW_REL_BAR}"


# S: every (G, P) instance of K3, K4 and K5 with a full and a ragged group
GROUP_S = [1, 2, 3, 4, 5, 8, 9, 16, 31, 33, 64, 100, 128]


@pytest.mark.parametrize("S", GROUP_S)
def test_grouped_sums_and_merged_backward_sum(S):
    w, col, pinit, lp, valid = _case(40, 5, S, seed=S)
    ahat, bhat, _ = emulate_scan(w, col, pinit, lp)
    ref_a, _ = fbs.fb_scan_fwd_plain(w, col, pinit, lp)
    ref_b = fbs.fb_scan_bwd_plain(w, col, lp)
    _assert_close(ahat, ref_a, valid, "ahat")
    _assert_close(_norm(bhat), _norm(ref_b), valid, "bhat")
    # absent speakers of lane 0 get cu backward and nothing forward
    if S > 2:
        assert torch.all(ahat[:, 0, -2:] == 0)
        assert torch.all(bhat[:-1, 0, -2:] > 0)


@pytest.mark.parametrize("S", GROUP_S)
def test_forward_chain_cfw(S):
    """K4's c_t, one floored group sum a frame and lane, against the
    forward twin's cfw, with the reciprocal two ulp off (it does not enter
    c_t of the same frame, only later frames through ahat)."""
    w, col, pinit, lp, valid = _case(40, 5, S, seed=100 + S)
    ahat, _, cfw = emulate_scan(w, col, pinit, lp, ulps=2, backward=False)
    ref_a, ref_c = fbs.fb_scan_fwd_plain(w, col, pinit, lp)
    assert cfw.shape == ref_c.shape == w.shape[:2]
    assert torch.all(cfw >= torch.tensor(TINY, dtype=F32))
    _assert_cfw_close(cfw, ref_c, valid)
    _assert_close(ahat, ref_a, valid, "ahat")


@pytest.mark.parametrize("ulps", [-2, -1, 1, 2])
@pytest.mark.parametrize("S", [8, 31])
def test_reciprocal_off_by_ulps(ulps, S):
    w, col, pinit, lp, valid = _case(300, 4, S, seed=10 + S)
    ahat, bhat, _ = emulate_scan(w, col, pinit, lp, ulps=ulps)
    _assert_close(ahat, fbs.fb_scan_fwd_plain(w, col, pinit, lp)[0], valid,
                  "ahat")
    _assert_close(_norm(bhat), _norm(fbs.fb_scan_bwd_plain(w, col, lp)),
                  valid, "bhat")


@pytest.mark.parametrize("S", [3, 8])
def test_frames_under_the_floor(S):
    """Frames whose sum is under 1e-37 take the IEEE reciprocal of the
    floor (no ulp moved there), and c_t, as K4 stores it and as fb_scan
    rebuilds it from K3's ahat, is the floor, as the twin records it (the
    floored sum, never the raw one)."""
    w, col, pinit, lp, valid = _case(60, 3, S, seed=3, floor=True)
    assert float(w[20:22, 0].sum(-1).max()) < TINY
    ahat, bhat, k4_cfw = emulate_scan(w, col, pinit, lp, ulps=2)
    ref_a, ref_c = fbs.fb_scan_fwd_plain(w, col, pinit, lp)
    prev = torch.cat([pinit[None], lp * ahat[:-1] + col[None]], 0)
    cfw = torch.clamp((w * prev).sum(-1), min=TINY)
    tiny = torch.tensor(TINY, dtype=F32)
    assert torch.all(ref_c[20:22, 0] == tiny)
    for got in (cfw, k4_cfw):
        assert torch.all(got[20:22, 0] == tiny)
        _assert_cfw_close(got, ref_c, valid)
    _assert_close(ahat, ref_a, valid, "ahat")
    _assert_close(_norm(bhat), _norm(fbs.fb_scan_bwd_plain(w, col, lp)),
                  valid, "bhat")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("T,S,B", [(40, 5, 3), (600, 31, 4)])
def test_emulation_matches_fb_scan_pallas(T, S, B, fused):
    """fb_scan with K3 (fused) or K4 and K5 (two-pass) replaced by their
    emulations, against vbx_tpu's fb_scan_pallas run in interpret mode on
    the same inputs. cfw as fb_scan rebuilds it (fused) or as K4 stores
    it."""
    w, m, col, pinit, valid, _, lp = _problem(T, S, B, seed=T + S,
                                              short_lane=(1, T - T // 5))
    j = [np.asarray(x) for x in fb_scan_pallas(
        jnp.asarray(w), jnp.asarray(valid), jnp.asarray(col),
        jnp.asarray(pinit), lp, interpret=True, fused=fused)]
    vm = torch.from_numpy(valid)[:, :, None]
    wf = (torch.from_numpy(w) * vm + (1 - vm) / S).contiguous()
    colt, pint = torch.from_numpy(col), torch.from_numpy(pinit)
    if fused:
        ahat, bhat, _ = emulate_scan(wf, colt, pint, lp, ulps=1)
        prev = torch.cat([pint[None], lp * ahat[:-1] + colt[None]], 0)
        cfw = torch.clamp((wf * prev).sum(-1), min=TINY)
    else:
        ahat, _, cfw = emulate_scan(wf, colt, pint, lp, ulps=1,
                                    backward=False)
        _, bhat, _ = emulate_scan(wf, colt, pint, lp, ulps=-1, forward=False)
    ok = valid.astype(bool)
    assert np.abs(ahat.numpy() - j[0])[ok].max() <= AHAT_BAR
    jb = j[1] / j[1].sum(-1, keepdims=True)
    assert np.abs(_norm(bhat).numpy() - jb)[ok].max() <= BHAT_BAR
    assert (np.abs(cfw.numpy() - j[2]) / j[2])[ok].max() <= CFW_REL_BAR


# ---- the row ring (fb_step.cuh: RowStager) --------------------------------

def row_stride_bytes(row_bytes, frame_stride_bytes):
    stride = row_bytes + 12
    while (stride - frame_stride_bytes) % 16:
        stride += 4
    return stride


def row_ring_bytes(stride, log_f):
    return ((stride + 15) // 16 * 16 + ((1 << log_f) + 1) * stride + 16
            + 15) // 16 * 16


def ring_geometry(B, S):
    """launch<G, P>'s choices in fb_scan_tbs.cu: (G, lanes a warp, log_f,
    stride, buffer bytes, dynamic shared memory of a block)."""
    G, _ = pick_group(S)
    lanes = 32 // G
    log_f = pick_log_chunk(lanes * S * 4)
    stride = row_stride_bytes(lanes * S * 4, B * S * 4)
    buf = row_ring_bytes(stride, log_f)
    return G, lanes, log_f, stride, buf, _constant("kStages") * (buf + 8)


def walk_warp(memory, lo, hi, T, B, S, b0, forward):
    """One warp's walk (lanes b0 ..), mirrored: the chunks in walk order,
    each row staged as RowStager.start plans it into a zeroed ring, then
    every lane's moving read pointer over the chunk as forward_rows /
    backward_rows move it. Checks each copy and read on the way; returns
    the frames each lane was handed, in walk order."""
    _, lanes, log_f, stride, buf, _ = ring_geometry(B, S)
    stages, F = _constant("kStages"), 1 << log_f
    nl = min(lanes, B - b0)
    row_bytes, fs = nl * S * 4, B * S * 4
    first = lo + b0 * S * 4
    front = (stride + 15) // 16 * 16
    n_chunks = (T + F - 1) // F
    ring = np.zeros(stages * buf, np.uint8)
    seen = {i: [] for i in range(lanes)}
    for q in range(n_chunks):
        c = q if forward else n_chunks - 1 - q
        t0, n = c * F, min(F, T - c * F)
        base = (q % stages) * buf
        ring[base:base + buf] = 0
        slot = base + front + ((first + t0 * fs) & 15)
        written = np.zeros(buf, bool)
        for r in range(n):
            s = first + (t0 + r) * fs
            dst = slot + r * stride - (s & 15)
            assert dst % 16 == 0
            r0, vectors, singles = staged_run(lo, hi, s, s + row_bytes, 4)
            assert r0 == s & ~15
            for a in vectors:
                assert a % 16 == 0 and lo <= a and a + 16 <= hi
                d = dst + a - r0
                assert base <= d and d + 16 <= base + buf
                assert not written[d - base:d - base + 16].any()
                written[d - base:d - base + 16] = True
                ring[d:d + 16] = memory[a:a + 16]
            for a in singles:
                assert s <= a and a + 4 <= s + row_bytes
                d = dst + a - r0
                assert not written[d - base:d - base + 4].any()
                written[d - base:d - base + 4] = True
                ring[d:d + 4] = memory[a:a + 4]
        for i in range(lanes):
            li = min(i, nl - 1)          # lanes past B repeat lane B - 1
            rd = li * S * 4

            def read(p):
                assert base <= p and p + S * 4 <= base + buf
                return ring[p:p + S * 4].copy()

            if forward:
                wp = slot + rd
                for t in range(t0, t0 + n):
                    frame = read(wp)
                    wp += stride
                    read(wp)                   # the next frame, read ahead
                    seen[i].append((t, frame))
            else:
                f0, f1 = max(t0, 1), t0 + n - 1
                wp = slot + (f1 - t0) * stride + rd
                for f in range(f1, f0 - 1, -1):
                    frame = read(wp)
                    wp -= stride
                    read(wp)
                    seen[i].append((f, frame))
    return seen, nl


# (B, S): rows of B * S * 4 bytes that are multiples of 16 and not, odd S,
# every lane count a warp has, batches that fill the last warp and do not;
# at (33, 1) and (34, 1) a stride of row_bytes + 8 would let neighbouring
# rows' copies overlap
ROW_CASES = [(256, 31), (37, 31), (5, 1), (9, 3), (11, 9), (4, 8), (3, 5),
             (6, 64), (3, 128), (2, 2), (7, 33), (34, 4), (33, 1), (34, 1)]


@pytest.mark.parametrize("t_kind", ["1", "2", "3", "F-1", "F", "F+1",
                                    "2F+3"])
@pytest.mark.parametrize("B,S", ROW_CASES)
def test_row_ring_hands_every_lane_its_frames(B, S, t_kind):
    """For tensors starting 0-7 floats past a 16-byte boundary, the first
    and last warps of the batch and both walk directions: each lane reads its own frames (lanes past
    the batch its last lane's), the forward walk frames 0 .. T-1 and the
    backward walk frames T-1 .. 1, each once and in order; every bulk copy
    is 16-byte aligned at both ends and inside the tensor, single elements
    lie inside their row, no two copies of a chunk write the same byte,
    and the read one row ahead stays inside the buffer."""
    F = 1 << ring_geometry(B, S)[2]
    T = {"F-1": F - 1, "F": F, "F+1": F + 1, "2F+3": 2 * F + 3}.get(
        t_kind) or int(t_kind)
    lanes = ring_geometry(B, S)[1]
    rng = np.random.default_rng(B * S + T)
    n_bytes = T * B * S * 4
    for base_elements in range(8):
        lo = 512 + 4 * base_elements
        hi = lo + n_bytes
        memory = np.zeros(hi + 64, np.uint8)
        memory[lo:hi] = rng.integers(1, 256, n_bytes, dtype=np.uint8)
        w = memory[lo:hi].view(np.float32).reshape(T, B, S)
        # the first four warps (their rows' offsets from a 16-byte boundary
        # repeat after four) and the last two (the tensor's end)
        warps = list(range(0, B, lanes))
        for b0 in sorted(set(warps[:4] + warps[-2:])):
            for forward in (True, False):
                seen, nl = walk_warp(memory, lo, hi, T, B, S, b0, forward)
                want = (list(range(T)) if forward
                        else list(range(T - 1, 0, -1)))
                for i, frames in seen.items():
                    b = b0 + min(i, nl - 1)
                    assert [t for t, _ in frames] == want
                    for t, got in frames:
                        np.testing.assert_array_equal(
                            got.view(np.float32), w[t, b])


def test_group_and_ring_choices_fit_the_card():
    """For every S the API takes: the group shape's instance exists in the
    source, the row of a warp is at most 512 bytes, a chunk is 4-128 rows,
    and the ring and mbarriers of a one-warp block fit the default 48 KB of
    dynamic shared memory whatever B (the launcher does not raise it)."""
    pairs = {(int(g), int(p)) for g, p in re.findall(
        r"^  FB_SCAN_GROUP\((\d+), (\d+)\)$", _source("fb_scan_tbs.cu"),
        re.M)}
    assert pairs == {(1, 4), (2, 4), (4, 4), (8, 4), (16, 4), (32, 4)}
    for S in range(1, fbs.S_MAX + 1):
        assert pick_group(S) in pairs
        for B in (1, 2, 3, 5, 37, 256, 1001):
            G, lanes, log_f, stride, buf, smem = ring_geometry(B, S)
            assert lanes * S * 4 <= 512 and 2 <= log_f <= 7
            assert stride >= lanes * S * 4 + 12
            assert (stride - B * S * 4) % 16 == 0 and buf % 16 == 0
            assert smem <= 48 * 1024
    assert ring_geometry(256, 31)[:3] == (8, 4, 4)   # 16 rows of 496 bytes


# ---- the scripts beside the kernels -----------------------------------------

def _load(path):
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TUNING = _load(os.path.join(ROOT, "scripts", "torch_fb_scan_tuning.py"))


@pytest.mark.parametrize("kernel,tag", [
    (kernel, tag) for kernel, (variants, _) in TUNING.KERNELS.items()
    for tag in variants])
def test_tuning_variants_still_address_the_shipped_sources(kernel, tag):
    """Every text scripts/torch_fb_scan_tuning.py replaces is found in
    fb_scan_tbs.cu or fb_step.cuh (it raises on the card otherwise), and
    every variant but 'shipped' changes one of them."""
    src_subs, header_subs = TUNING.KERNELS[kernel][0][tag]
    src, header = _source("fb_scan_tbs.cu"), _source("fb_step.cuh")
    changed = (TUNING.variant_source(src, src_subs) != src
               or TUNING.variant_source(header, header_subs) != header)
    assert changed == (tag != "shipped")
