#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vbx_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each of which exits non-zero on failure:

1. the card's name and power limit (nvidia-smi);
2. build every kernel from the checkout's sources (one nvcc per source,
   all started together) and print the build seconds and ptxas report;
3. kernel phase: each kernel against its plain PyTorch twin on the card,
   float32 and bfloat16 streams. K1 (fb_fused_sb) at the bench shape
   (B=256, T=1025, S=31) and at CHECK_SHAPES (S from 8 to 4096, the main
   path's largest bucket, with skip_dead, a random boundary message and
   all-zero padded frames the bench shape and the mesh path's shard shape
   B=4, T=8192, S=8, and what the kernel's design can get wrong: every
   group shape with a ragged edge, T of 1-3 frames and just under and over
   one staged chunk, batches that do not fill a warp, lanes that start at
   odd byte offsets, leading dead frames and an all-dead lane, frames whose
   sum is under the 1e-37 floor), with the tolerances of
   tests/test_torch_fb_kernel.py; K1 again at the solo long-recording
   shape B=4, T=32768, S=8 (timed, float32 held to its twin); and lanes
   of a B=256 launch bit-equal to the same lanes launched alone and among
   other neighbours. K2 (fb_fwd_product_sb) at K2_SHAPES (the mesh path's
   shard shape B=4, Tb=8192, S=8, R=16 with two trailing dead segments on
   one lane; S=31; S=128; a segment shorter than one staged chunk and one
   that is no multiple of it), with the tolerance of
   tests/test_torch_gpu.py, and its rows bit-equal whatever lanes share
   the launch. K3-K5 (fb_scan_tbs, the [T, B, S] walks) at SCAN_SHAPES
   (the A/B tool's shape T=1025, B=256, S=31, tests/test_pallas.py's
   shapes, every group shape of K3-K5 with batches that do not fill a
   warp, walks of 1-3 frames and one frame under and over a staged chunk,
   frames under the 1e-37 floor) within SCAN_BARS, K4's ahat bit-equal to
   K3's, the API's fused route against its two-pass route, K3 against K1
   on the same inputs transposed, and K3, K4 and K5 lanes of the A/B launch
   bit-equal to the same lanes launched alone and among other neighbours.
   CUDA-event times
   (median of 25 launches), the twin's time, and the bytes/operations
   bound;
4. main path: a synthetic corpus of 64 recordings (T 500-2000 x-vectors,
   256-d, 2-6 speakers, vbx_tpu_torch.testing) through
   engine.pipeline.diarize_ark on cuda, once with fb_impl='pallas' and
   once with the callhome preset, which resolves to 'pallas_bf16';
   each run must write every RTTM, launch the kernel (its launch counter
   is reset just before the run and read just after), and agree with the
   synthetic truth on >= 95% of frames. A small corpus also runs on the
   CPU's structured engine (the reference route) and the kernel route's
   labels must agree with it on >= 99.5% of frames. Then a warm rerun
   gives the e2e seconds per recording, and the VB engine alone runs to
   convergence at the bench shape (D=128) for VB recordings per second.
   On the same corpus, the diagnostics that need it: vbx_debug on one
   recording against its truth labels (float32 on the card: ELBO trace
   non-decreasing to roundoff, final frame DER printed), and cli/score.py
   over the f32 run's RTTMs against truth RTTMs written from the synthetic
   labels (the OVERALL row; DER and JER are information);
5. mesh path: 4 AMI-length synthetic recordings (32768, 30000, 24000 and
   17000 x-vectors, 8 speakers, init random_8+VB) through diarize_ark on
   a 1x4 mesh of cuda:0 repeated with fb_impl 'pallas' and 'pallas_bf16',
   and on a 2x2 mesh with 'pallas'. Each run must write every RTTM, find
   >= 2 speakers per recording and launch both K2 and K1 (counters reset
   before the run, read after), and its labels must agree with the solo
   kernel route of the same fb_impl on >= 99.5% (f32) / 99% (bf16) of
   frames. Then ms per EM iteration of the sharded and the solo engine at
   that shape. One card runs the four shards one after another on one
   stream: these times are the shards' summed work, not multi-card
   scaling. Then vbx_batched_checkpointed(mesh=) on the longest recording:
   stopped after its first slice and resumed from its file, it must equal
   the unsliced vbx_sharded run bit for bit;
6. diagnostics path at full width: the kernel A/B tool
   (scripts/torch_ab_fb_kernels.py main() at its defaults: fb_scan fused
   against two-pass, then a 10-iteration EM A/B of the kernel route against
   the structured route), with K3-K5's launch counters reset just before
   and read just after; vbx_batched_checkpointed at the bench shape on the
   kernel route, 4 iterations per slice, stopped after the first slice and
   resumed from its file: n_iters, gamma and the ELBO trace bit-equal to
   the unsliced vbx_batched run, the file gone at the end;
   forward_backward_assoc against forward_backward_structured at T=1025,
   S=31 on the card (float64 within 1e-9; float32 within ASSOC_F32_BAR);
7. extraction path at full width: 4 synthetic recordings of 5 minutes at
   16 kHz (vbx_tpu_torch.testing.synth_audio: harmonic voices over noise,
   VAD segments of 0.6-8 s, then one shorter than an analysis window and
   one that gives only a tail window) through engine.extractor's
   extract_to_ark on cuda at batch 128, with ResNet101 (32 base channels,
   [3, 4, 23, 3], 64 x 144 windows, 256-d; seeded default init, embedding
   bias zero) in float32 (TF32 off) and in bfloat16, cold and warm; and on
   the CPU with a narrow ResNet (keys and times do not depend on the
   model). Each run must write one x-vector per window, with the CPU
   run's keys and segments file. Checks: features of one recording, card
   vs CPU, within FEATURE_F32_BAR; 16 windows (14 full, tails of 10 and
   77 frames) of the float32 model on the card against the same model on
   the CPU on the same windows: cosine >= EXTRACT_F32_COS, max abs error
   <= EXTRACT_F32_ERR x max, and the float32 ark's x-vectors of the 14
   full windows (extract_to_ark's own unmasked batches) against the same
   CPU rows at those bars; the two tails padded against their
   true-length runs on the card, within EXTRACT_F32_ERR x max; bfloat16
   against float32, every x-vector's cosine > EXTRACT_BF16_COS. Timing
   (CUDA events, median after a warm-up): ms per 128-window batch,
   windows/s, audio seconds/s and TFLOP/s, float32 and bfloat16, beside
   the bound (FLOPs from the layer shapes over 67 or 989 TFLOP/s), and
   fbank + CMVN of one recording beside its bound (and once with its
   cuFFT plans made anew, as a new recording makes them). Then the float32 ark +
   segments go through diarize_ark on cuda (kernel route, K1's launches
   counted) with a synthetic 256-d PLDA and transform: an RTTM for every
   recording (random weights: no DER is claimed);
8. one JSON line listing every ported kernel with its numbers, the total
   seconds;
9. the last line: {"ok": true, "device": {"platform": "gpu", ...}}.

Without a card, or outside a checkout, it exits non-zero before printing
any result.
"""

import contextlib
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = dict(B=256, T=1025, S=31, D=128)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
# tests/test_torch_fb_kernel.py bars: gamma atol, log_px rtol, pi_stat x max
BARS = {"float32": (2e-5, 1e-5, 2e-4), "bfloat16": (8e-3, 2e-3, 2e-2)}
# tests/test_torch_gpu.py's K2 bar (kernel vs twin, both float32 walks on
# the same stream; a row's S products summed in another order): fhat
# relative to each row's max, ls relative to max(1, |ls|)
K2_BAR = 4e-6
# K3-K5 against their twins (both float32 walks on the same weights: they
# differ in summation order and FMA contraction): ahat absolute, bhat
# absolute after per-frame normalization, cfw relative, on valid frames
SCAN_BARS = {"ahat": 2e-5, "bhat_normalized": 2e-5, "cfw_rel": 1e-5}
# forward_backward_assoc against the structured smoother, float32 gamma at
# T=1025, S=31. The assoc form carries rounding through its log2(T)
# composition rounds: on these inputs it differs from the structured
# smoother by 6.7e-4 on a CPU, and vbx_tpu's own float32 assoc by 7.6e-4
# from its own structured smoother, so 2e-5 is out of the algorithm's reach
# in float32. The bar is tests/test_forward_backward.py's for the assoc
# form at long T; float64 is held at 1e-9.
ASSOC_F32_BAR = 2e-3
N_RECORDINGS = 64
MESH_LENGTHS = (32768, 30000, 24000, 17000)
MESH_SPEAKERS = 8
# mesh vs solo label agreement bars
MESH_AGREE = {"pallas": 0.995, "pallas_bf16": 0.99}
# extraction path (phase 7): 4 synthetic recordings of 5 minutes at 16 kHz
EXTRACT_SECONDS = (300.0, 300.0, 300.0, 300.0)
EXTRACT_FS = 16000
EXTRACT_BATCH = 128
BF16_OPS_PER_S = 989e12        # H100 SXM bfloat16 dense, tensor cores
# card vs CPU, float32 model on the same 16 windows: cosine, max abs error
# x max (tests/test_resnet.py's bar); bfloat16 vs float32 cosine
# (tests/test_extractor.py's bar); features card vs CPU
# (tests/test_torch_features.py's float32 fbank bar, log domain)
EXTRACT_F32_COS = 0.99999
EXTRACT_F32_ERR = 2e-4
EXTRACT_BF16_COS = 0.999
FEATURE_F32_BAR = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def _cuda_ms(fn, n: int = 25) -> float:
    """Median of n single-launch CUDA-event timings, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _host_ms(fn, n: int = 3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# shapes the kernel is held to its twin at, besides the bench shape:
# (name, B, T, S, padded lanes, skip_dead). One warp per chain with one and
# several speakers per thread; several-warp chains past 256 speakers; the
# main path's largest bucket (S_pad 8, T_pad 2048, lanes of 500-2048 valid
# frames followed by the uniform padded suffix); and the mesh path's mode
# (skip_dead, all-zero padded frames, a random boundary message) at the
# bench shape and at the mesh path's shard shape. Then what the kernel's
# design can get wrong: each group shape (threads per lane x speakers per
# thread, from S) with a ragged last thread and a batch that does not fill
# its warps (S=1: 32 lanes a warp, S=2: 32, S=9: 8, S=33: 2); walks of 1-3
# frames; walks one frame under and over one staged chunk (S=31: 64 frames
# in float32, 128 in bfloat16); odd T with odd S, where bfloat16 lanes start
# 2 bytes off a 16-byte boundary; with skip_dead, lane 0 starting with dead
# frames and the last lane all dead; and two frames of lane 0 scaled by
# 1e-38, so that their sums lie under the 1e-37 floor.
CHECK_SHAPES = (("S8", 32, 400, 8, "one", False),
                ("S64", 32, 400, 64, "one", False),
                ("S256", 32, 400, 256, "one", False),
                ("S300", 8, 200, 300, "one", False),
                ("S4096", 4, 200, 4096, "one", False),
                ("bucket", 64, 2048, 8, "all", False),
                ("bench_skip_dead", 256, 1025, 31, "one", True),
                ("shard_skip_dead", 4, 8192, 8, "shard", True),
                ("S1", 37, 40, 1, "one", False),
                ("S2", 37, 40, 2, "one", False),
                ("S9", 7, 130, 9, "one", False),
                ("S33", 5, 70, 33, "one", False),
                ("T1", 3, 1, 31, "one", False),
                ("T2", 3, 2, 31, "one", False),
                ("T3", 5, 3, 8, "one", False),
                ("chunk_f32_minus_1", 5, 63, 31, "one", False),
                ("chunk_f32_plus_1", 5, 65, 31, "one", False),
                ("chunk_bf16_minus_1", 5, 127, 31, "one", False),
                ("chunk_bf16_plus_1", 5, 129, 31, "one", False),
                ("odd_T_odd_S", 9, 77, 5, "one", False),
                ("dead_lead", 6, 300, 8, "dead", True),
                ("floor", 4, 200, 8, "floor", False))


def kernel_case(B, T, S, io, padded, seed, skip_dead=False):
    """random_hmm_problem-like inputs on the card: log-likelihoods, one
    lane with two absent speakers (where S > 2), and padded frames: lane 1
    short by T/5 ('one', 'floor'); every lane of a random length in
    [500, T] ('all'); lane 1 short by 40% and lane 3 all padding, as
    shards of a long recording's tail are ('shard'); or lane 0's first 5
    frames and the whole last lane ('dead'). Padded frames are the
    engine's uniform suffix of 1/S, or all zero with skip_dead, which also
    draws a random non-uniform boundary message binit (the mesh path's
    mode). 'floor' scales two valid frames of lane 0 by 1e-38."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    log_p = 3.0 * torch.randn((B, T, S), generator=gen, device="cuda") - 30
    smask = torch.ones((B, S), device="cuda")
    gone = min(2, B - 1)
    if S > 2:
        smask[gone, -2:] = 0
        log_p[gone, :, -2:] = -1e30
    if padded == "all":
        lengths = torch.randint(500, T + 1, (B,), generator=gen,
                                device="cuda")
    else:
        lengths = torch.full((B,), T, device="cuda")
        lengths[1] = T - (2 * T // 5 if padded == "shard" else T // 5)
        if padded == "shard":
            lengths[3] = 0
    valid = (torch.arange(T, device="cuda")[:, None]
             < lengths[None, :]).float()                            # [T, B]
    if padded == "dead":
        valid[:5, 0] = 0.0
        valid[:, B - 1] = 0.0
    pi = torch.rand((B, S), generator=gen, device="cuda") * smask
    pi /= pi.sum(-1, keepdim=True)
    lp = 0.99
    vm = valid.T[:, :, None]
    m = log_p.amax(-1)
    w = (torch.exp(log_p - m[..., None]) * smask[:, None, :]) * vm
    if skip_dead:
        binit = (torch.rand((B, S), generator=gen, device="cuda") + 0.05
                 ) * smask
        binit /= binit.sum(-1, keepdim=True)
    else:
        w = w + (1 - vm) / S
        binit = torch.full((B, S), 1.0 / S, device="cuda")
    if padded == "floor":
        w[0, T // 3:T // 3 + 2] *= 1e-38
    return dict(w=w.to(io).contiguous(),
                col=((1 - lp) * pi + 1e-8).contiguous(),
                pinit=(pi + 1e-8).contiguous(), binit=binit.contiguous(),
                lp=lp, valid=valid, m=m, skip_dead=skip_dead)


def kernel_errors(case, io_name):
    """fb_fused_sb against fb_fused_sb_plain on one case: the errors, and
    the names of those past tests/test_torch_fb_kernel.py's bars."""
    import torch

    from vbx_tpu_torch.ops import fb_kernel

    w, valid, m = case["w"], case["valid"], case["m"]
    args = (w, case["col"], case["pinit"], case["binit"], case["lp"])
    k = fb_kernel.fb_fused_sb(*args, recip=True, skip_dead=case["skip_dead"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = fb_kernel.fb_fused_sb_plain(*args, recip=True,
                                    skip_dead=case["skip_dead"])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    def assemble(ahat, bhat, cfw):
        a, b = ahat.float(), bhat.float()
        ab = a * b
        denom = ab.sum(-1, keepdim=True).clamp(min=1e-37)
        vbt = valid.T
        gamma = ab / denom * vbt[:, :, None]
        log_px = (vbt * (m + torch.log(cfw))).sum(1)
        nf = vbt.clone()
        nf[:, 0] = 0
        terms = w.float() * b / (denom * cfw[:, :, None])
        return gamma, log_px, (terms * nf[:, :, None]).sum(1), \
            b / b.sum(-1, keepdim=True)

    gk, lk, pk, bk = assemble(*k)
    gp, lpp, pp, bp = assemble(*p)
    vmask = valid.T.bool()
    if case["skip_dead"] and not torch.all(k[2][~vmask] == 1.0):
        return {}, ["cfw at skipped frames"]
    err = {
        "plain_ms": plain_ms,
        "ahat": (k[0].float() - p[0].float()).abs()[vmask].max().item(),
        "bhat_normalized": (bk - bp).abs()[vmask].max().item(),
        "gamma": (gk - gp).abs().max().item(),
        "cfw_rel": ((k[2] - p[2]).abs() / p[2])[vmask].max().item(),
        "log_px_rel": ((lk - lpp).abs() / lpp.abs().clamp(min=1.0)
                       ).max().item(),
        "pi_stat_over_max": ((pk - pp).abs().max()
                             / pp.abs().max().clamp(min=1e-30)).item(),
    }
    gtol, ltol, ptol = BARS[io_name]
    bad = [name for name, val, bar in (
        ("ahat", err["ahat"], gtol), ("bhat", err["bhat_normalized"], gtol),
        ("gamma", err["gamma"], gtol), ("cfw", err["cfw_rel"], ltol),
        ("log_px", err["log_px_rel"], ltol),
        ("pi_stat", err["pi_stat_over_max"], ptol)) if not val <= bar]
    return err, bad


def k1_bound(B, T, S, esize) -> dict:
    """The least time the card could take for one fb_fused_sb call: read w
    once, write ahat / bhat once (stream type) and cfw (float32), read
    col / pinit / binit (float32); ~12 float32 operations per (lane, frame,
    speaker) across both chains. scripts/kernel_bounds.py computes the
    same from the shapes alone."""
    bytes_moved = 3 * B * T * S * esize + B * T * 4 + 3 * B * S * 4
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = 12 * B * T * S / F32_OPS_PER_S * 1e3
    return {"bytes": bytes_moved, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def k1_batch_invariance(case) -> dict:
    """Lanes of one launch against the same lanes launched alone and among
    other neighbours (at another place in the batch): every output must be
    bit-equal, because the group that holds a lane depends on S only."""
    import torch

    from vbx_tpu_torch.ops import fb_kernel

    names = ("w", "col", "pinit", "binit")
    B = case["w"].shape[0]

    def run(idx=None):
        args = [case[n] if idx is None else case[n][idx].contiguous()
                for n in names]
        return fb_kernel.fb_fused_sb(*args, case["lp"], recip=True,
                                     skip_dead=case["skip_dead"])

    full = run()
    lanes = sorted({0, 1, B // 2 + 2, B - 1})
    for i in lanes:
        alone = run(slice(i, i + 1))
        among = run(torch.tensor([(7 * i + 3) % B, i, (i + 101) % B,
                                  5 % B, (B - 6) % B], device="cuda"))
        torch.cuda.synchronize()
        for name, f, a, m in zip(("ahat", "bhat", "cfw"), full, alone, among):
            if not (torch.equal(f[i], a[0]) and torch.equal(f[i], m[1])):
                fail(f"fb_fused_sb {case['w'].dtype}: {name} of lane {i} in "
                     f"a batch of {B} differs from the lane launched alone "
                     f"or among other neighbours")
    return {"lanes": lanes, "batch": B, "bit_equal": True}


LONG = dict(B=4, T=32768, S=8)     # the solo long-recording K1 shape


def long_shape(io_name: str) -> dict:
    """fb_fused_sb at the solo long-recording shape (the mesh corpus's
    padded batch on one device): timed, with its bound; in float32 also
    held to its plain twin (one run of the twin, whose time is taken)."""
    import torch

    from vbx_tpu_torch.ops import fb_kernel

    B, T, S = LONG["B"], LONG["T"], LONG["S"]
    case = kernel_case(B, T, S, getattr(torch, io_name), "one", seed=77)
    args = (case["w"], case["col"], case["pinit"], case["binit"], case["lp"])
    out = {"name": f"fb_fused_sb[{io_name}] at B,T,S={B},{T},{S}",
           "route": "cuda", "source": "vbx_tpu_torch/csrc/fb_fused_sb.cu",
           "replaces": "vbx_tpu/ops/fb_pallas.py:198", "launches": None,
           "library_ms": None, "shape": [B, T, S],
           **k1_bound(B, T, S, case["w"].element_size())}
    if io_name == "float32":
        err, bad = kernel_errors(case, io_name)
        if bad:
            fail(f"fb_fused_sb {io_name} at B={B}, T={T}, S={S} disagrees "
                 f"with its plain twin on {bad}: {err}")
        out.update(max_abs_err=max(err["ahat"], err["bhat_normalized"],
                                   err["gamma"]),
                   plain_ms=err["plain_ms"], checks={"long": err})
    out["ms"] = _cuda_ms(lambda: fb_kernel.fb_fused_sb(*args, recip=True))
    return out


def kernel_phase(io_name: str) -> dict:
    """fb_fused_sb against fb_fused_sb_plain on the same card inputs: at
    the bench shape (timed), and at CHECK_SHAPES."""
    import torch

    from vbx_tpu_torch.ops import fb_kernel

    io = getattr(torch, io_name)
    B, T, S = BENCH["B"], BENCH["T"], BENCH["S"]
    checks = {}
    for i, (name, b, t, s, padded, skip_dead) in enumerate(
            (("bench", B, T, S, "one", False),) + CHECK_SHAPES):
        case = kernel_case(b, t, s, io, padded, seed=i, skip_dead=skip_dead)
        err, bad = kernel_errors(case, io_name)
        if bad:
            fail(f"fb_fused_sb {io_name} at {name} (B={b}, T={t}, S={s}) "
                 f"disagrees with its plain twin on {bad}: {err}")
        checks[name] = {"shape": [b, t, s], **err}
        if name == "bench":
            bench = case
    w = bench["w"]
    args = (w, bench["col"], bench["pinit"], bench["binit"], bench["lp"])
    ms = _cuda_ms(lambda: fb_kernel.fb_fused_sb(*args, recip=True))
    plain_ms = _host_ms(lambda: fb_kernel.fb_fused_sb_plain(*args,
                                                            recip=True))
    invariance = k1_batch_invariance(bench)
    return {"name": f"fb_fused_sb[{io_name}]", "route": "cuda",
            "source": "vbx_tpu_torch/csrc/fb_fused_sb.cu",
            "replaces": "vbx_tpu/ops/fb_pallas.py:198",
            "launches": None,
            "max_abs_err": max(max(c["ahat"], c["bhat_normalized"],
                                   c["gamma"]) for c in checks.values()),
            "ms": ms, "plain_ms": plain_ms,
            **k1_bound(B, T, S, w.element_size()),
            # no single PyTorch call computes this smoother
            "library_ms": None, "batch_invariance": invariance,
            "checks": checks, "shape": [B, T, S]}


# K2 shapes: (name, B, Tb, S, R). The mesh path's shard shape (a T_pad
# 32768 bucket over 4 'sp' shards: B=4, Tb=8192, S_pad 8, R=16 segments of
# Ts=512 by parallel.fb_blockwise._auto_segments), then S=31 and S=128, a
# segment shorter than one staged chunk (S=8: 64 frames) and one that is no
# multiple of it.
K2_SHAPES = (("shard", 4, 8192, 8, 16), ("S31", 4, 2048, 31, 4),
             ("S128", 2, 1024, 128, 2), ("short_segment", 3, 96, 8, 4),
             ("ragged_segment", 2, 300, 8, 3))


def k2_case(B, Tb, S, R, io, seed):
    """Emission weights (max 1 per frame) on the card with lane 0's last
    speaker absent and lane 1 ending in a padded suffix of all-zero frames:
    with R >= 4 its last two segments are wholly dead and the one before
    is a third dead. finit rows e_i for segment 0 (the global first frame)
    and the folded transition lp * e_i + col elsewhere, as the blockwise
    smoother builds them."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    log_p = 3.0 * torch.randn((B, Tb, S), generator=gen, device="cuda") - 30
    w = torch.exp(log_p - log_p.amax(-1, keepdim=True))
    w[0, :, -1] = 0.0
    Ts = Tb // R
    w[1, ((R - 2) * Ts if R >= 4 else Tb) - Ts // 3:] = 0.0
    pi = torch.rand((B, S), generator=gen, device="cuda")
    pi /= pi.sum(-1, keepdim=True)
    lp = 0.99
    col = ((1 - lp) * pi + 1e-8).contiguous()
    eye = torch.eye(S, device="cuda")
    finit = (lp * eye + col[:, None, :]).expand(R, B, S, S).clone()
    finit[0] = eye
    return dict(w=w.to(io).contiguous(), col=col, finit=finit, lp=lp, R=R)


def k2_bound(B, Tb, S, R, esize) -> dict:
    """The least time the card could take for one fb_fwd_product_sb call:
    read w, col and finit once, write fhat and ls once; ~5 float32
    operations per (lane, row, frame, speaker). scripts/kernel_bounds.py
    computes the same from the shapes alone."""
    bytes_moved = (B * Tb * S * esize + B * S * 4 + 2 * R * B * S * S * 4
                   + R * B * S * 4)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = 5 * B * Tb * S * S / F32_OPS_PER_S * 1e3
    return {"bytes": bytes_moved, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def k2_phase(io_name: str) -> dict:
    """fb_fwd_product_sb against fb_fwd_product_sb_plain on the same card
    inputs at K2_SHAPES, each timed (the JSON line reports the shard
    shape's)."""
    import torch

    from vbx_tpu_torch.ops import fb_product_kernel as k2

    io = getattr(torch, io_name)
    bar = K2_BAR
    checks = {}
    for i, (name, B, Tb, S, R) in enumerate(K2_SHAPES):
        case = k2_case(B, Tb, S, R, io, seed=100 + i)
        args = (case["w"], case["col"], case["finit"], case["lp"])
        fk, lk = k2.fb_fwd_product_sb(*args)
        fp, lpl = k2.fb_fwd_product_sb_plain(*args)
        torch.cuda.synchronize()
        err = {"fhat_rel": float(((fk - fp).abs()
                                  / fp.abs().amax(-1, keepdim=True)).max()),
               "fhat_abs": float((fk - fp).abs().max()),
               "ls_rel": float(((lk - lpl).abs()
                                / lpl.abs().clamp(min=1.0)).max())}
        bad = [n for n in ("fhat_rel", "ls_rel") if not err[n] <= bar]
        if R >= 4 and not (torch.equal(fk[-1, 1], case["finit"][-1, 1])
                           and bool((lk[-1, 1] == 0).all())):
            bad.append("dead segment not skipped")
        if bad:
            fail(f"fb_fwd_product_sb {io_name} at {name} (B={B}, Tb={Tb}, "
                 f"S={S}, R={R}) disagrees with its plain twin on {bad}: "
                 f"{err}")
        # rows of a lane launched alone, and with the lanes in another
        # order, must be bit-equal to its rows in the full launch
        w, col, finit, lp = args
        back = torch.arange(B - 1, -1, -1, device="cuda")
        fr, lr = k2.fb_fwd_product_sb(w[back].contiguous(), col[back]
                                      .contiguous(),
                                      finit[:, back].contiguous(), lp)
        fa, la = k2.fb_fwd_product_sb(w[:1], col[:1],
                                      finit[:, :1].contiguous(), lp)
        torch.cuda.synchronize()
        if not (torch.equal(fr[:, back], fk) and torch.equal(lr[:, back], lk)
                and torch.equal(fa[:, 0], fk[:, 0])
                and torch.equal(la[:, 0], lk[:, 0])):
            fail(f"fb_fwd_product_sb {io_name} at {name}: a lane's rows "
                 f"depend on the lanes it is launched with")
        ms = _cuda_ms(lambda: k2.fb_fwd_product_sb(*args))
        plain_ms = _host_ms(lambda: k2.fb_fwd_product_sb_plain(*args))
        checks[name] = {"shape": [B, Tb, S, R], **err, "ms": ms,
                        "plain_ms": plain_ms,
                        **k2_bound(B, Tb, S, R, case["w"].element_size())}
    main = checks["shard"]
    return {"name": f"fb_fwd_product_sb[{io_name}]", "route": "cuda",
            "source": "vbx_tpu_torch/csrc/fb_fwd_product_sb.cu",
            "replaces": "vbx_tpu/ops/fb_pallas.py:548",
            "launches": None,
            "max_abs_err": max(c["fhat_abs"] for c in checks.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            # no single PyTorch call computes this walk
            "library_ms": None,
            "checks": checks, "bytes": main["bytes"],
            "shape": main["shape"]}


# K3-K5 shapes: (name, T, B, S, valid frames of lane B-1 or None, floor).
# The A/B tool's shape; tests/test_pallas.py's (40, 5, 3), (600, 31, 4) and
# its padded case T=100+30, S=6, B=1; S=64 and 128 (2 and 1 lanes a warp);
# a batch of 37. Then what the grouped-lane design of K3-K5 can get wrong
# (K4 also its cfw store): walks of 1-3 frames; walks one frame under and
# over one staged chunk (S=31: 16 rows); S=1 and 3 (32 lanes a warp) and 9
# (8 lanes a warp), with rows of B * S * 4 bytes that are no multiple of 16
# (B=37, 9, 11: the rows of consecutive frames start at other offsets from
# a 16-byte boundary); a batch of 5 lanes, which does not fill a warp of
# 32; and (floor) two frames of lane 0 scaled by 1e-38, so that their sums
# lie under the 1e-37 floor (K4 must store the floor, not the raw sum).
SCAN_SHAPES = (("ab", 1025, 256, 31, 820, False),
               ("t40", 40, 3, 5, None, False),
               ("t600", 600, 4, 31, 480, False),
               ("padded", 130, 1, 6, 100, False),
               ("S64", 200, 6, 64, 150, False),
               ("S128", 200, 8, 128, 150, False),
               ("B37", 300, 37, 31, 200, False),
               ("T1", 1, 5, 31, None, False),
               ("T2", 2, 5, 31, None, False),
               ("T3", 3, 3, 8, None, False),
               ("chunk_minus_1", 15, 5, 31, None, False),
               ("chunk_plus_1", 17, 5, 31, 12, False),
               ("S1", 130, 37, 1, 100, False),
               ("S3", 47, 9, 3, 30, False),
               ("S9", 33, 11, 9, 20, False),
               ("B5", 300, 5, 2, 200, False),
               ("floor", 200, 4, 8, 150, True))


def scan_case(T, B, S, n_valid, seed, floor=False):
    """[T, B, S] emission weights (max 1 per frame) on the card, lane 0's
    last two speakers absent (w and prior exactly 0), the last lane ending
    in a padded suffix after n_valid frames, with floor two frames of lane
    0 scaled by 1e-38, and the validity-filled copy fb_scan hands its
    kernels."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    log_p = 3.0 * torch.randn((T, B, S), generator=gen, device="cuda") - 30
    m = log_p.amax(-1)
    w = torch.exp(log_p - m[..., None])
    pi = torch.rand((B, S), generator=gen, device="cuda")
    if S > 2:
        w[:, 0, -2:] = 0.0
        pi[0, -2:] = 0.0
    if floor:
        w[T // 3:T // 3 + 2, 0] *= 1e-38
    pi /= pi.sum(-1, keepdim=True)
    valid = torch.ones((T, B), device="cuda")
    if n_valid is not None:
        valid[n_valid:, B - 1] = 0.0
    lp = 0.9
    vm = valid[:, :, None]
    return dict(w=w.contiguous(), wf=(w * vm + (1 - vm) / S).contiguous(),
                valid=valid, m=m, lp=lp,
                col=((1 - lp) * pi + 1e-8).contiguous(),
                pinit=(pi + 1e-8).contiguous())


def scan_phase() -> list:
    """K3 (fb_scan_fused), K4 (fb_scan_fwd) and K5 (fb_scan_bwd) against
    their plain twins on the same card inputs at SCAN_SHAPES, K4's ahat
    against K3's (bit for bit: one forward body), the fused route against
    the two-pass route, K3 against K1 on the same inputs transposed, and
    the times at the A/B shape."""
    import torch

    from vbx_tpu_torch.ops import fb_kernel
    from vbx_tpu_torch.ops import fb_scan_kernel as fbs

    def norm(b):
        return b / b.sum(-1, keepdim=True)

    checks = {"fb_scan_fused": {}, "fb_scan_fwd": {}, "fb_scan_bwd": {}}
    cross = {}
    for i, (name, T, B, S, n_valid, floor) in enumerate(SCAN_SHAPES):
        c = scan_case(T, B, S, n_valid, seed=200 + i, floor=floor)
        wf, col, pinit, lp = c["wf"], c["col"], c["pinit"], c["lp"]
        ok = c["valid"].bool()
        a3, b3 = fbs.fb_scan_fused(wf, col, pinit, lp)
        a4, c4 = fbs.fb_scan_fwd(wf, col, pinit, lp)
        b5 = fbs.fb_scan_bwd(wf, col, lp)
        ap, cp = fbs.fb_scan_fwd_plain(wf, col, pinit, lp)
        bp = fbs.fb_scan_bwd_plain(wf, col, lp)
        torch.cuda.synchronize()

        def err_a(a):
            return float((a - ap).abs()[ok].max())

        def err_b(b):
            return float((norm(b) - norm(bp)).abs()[ok].max())

        errs = {"fb_scan_fused": {"ahat": err_a(a3),
                                  "bhat_normalized": err_b(b3)},
                "fb_scan_fwd": {"ahat": err_a(a4), "cfw_rel": float(
                    ((c4 - cp).abs() / cp)[ok].max())},
                "fb_scan_bwd": {"bhat_normalized": err_b(b5)}}
        for kname, err in errs.items():
            bad = [n for n, v in err.items() if not v <= SCAN_BARS[n]]
            if bad:
                fail(f"{kname} at {name} (T={T}, B={B}, S={S}) disagrees "
                     f"with its plain twin on {bad}: {err}")
            checks[kname][name] = {"shape": [T, B, S], **err}
        if not torch.equal(a3, a4):
            fail(f"fb_scan_fwd's ahat at {name} (T={T}, B={B}, S={S}) is "
                 f"not fb_scan_fused's bit for bit: max difference "
                 f"{float((a3 - a4).abs().max())}")
        # the API's two routes against each other (the A/B tool's check)
        f = fbs.fb_scan(c["w"], c["valid"], col, pinit, lp, fused=True)
        t = fbs.fb_scan(c["w"], c["valid"], col, pinit, lp, fused=False)

        def gamma(a, b):
            ab = a * b
            return ab / ab.sum(-1, keepdim=True) * c["valid"][:, :, None]

        x = {"fused_vs_two_pass_gamma": float(
                 (gamma(f[0], f[1]) - gamma(t[0], t[1])).abs().max()),
             "fused_vs_two_pass_lognorm": float(
                 (torch.log(f[2]) - torch.log(t[2])).abs()[ok].max())}
        # K3 against K1 (the [B, T, S] fused kernel, divide form, uniform
        # backward start) on the same filled weights transposed
        k1 = fb_kernel.fb_fused_sb(
            wf.transpose(0, 1).contiguous(), col, pinit,
            torch.full((B, S), 1.0 / S, device="cuda"), lp, recip=False)
        torch.cuda.synchronize()
        a1, b1, c1 = (y.transpose(0, 1) for y in k1)
        x["k3_vs_k1_ahat"] = float((a3 - a1).abs()[ok].max())
        x["k3_vs_k1_bhat_normalized"] = float(
            (norm(b3) - norm(b1)).abs()[ok].max())
        x["k3_rebuilt_cfw_vs_k1_rel"] = float(
            ((f[2] - c1).abs() / c1)[ok].max())
        bad = [n for n, v in x.items()
               if not v <= (1e-5 if "cfw" in n or "lognorm" in n else 2e-5)]
        if bad:
            fail(f"fb_scan cross-check at {name} (T={T}, B={B}, S={S}) "
                 f"failed on {bad}: {x}")
        cross[name] = {"shape": [T, B, S], **x}
        if name == "ab":
            ab = c
    wf, col, pinit, lp = ab["wf"], ab["col"], ab["pinit"], ab["lp"]
    T, B, S = wf.shape

    def both_passes():
        fbs.fb_scan_fwd(wf, col, pinit, lp)
        fbs.fb_scan_bwd(wf, col, lp)

    rows = (("fb_scan_fused", ":150",
             lambda: fbs.fb_scan_fused(wf, col, pinit, lp),
             lambda: fbs.fb_scan_fused_plain(wf, col, pinit, lp)),
            ("fb_scan_fwd", ":92",
             lambda: fbs.fb_scan_fwd(wf, col, pinit, lp),
             lambda: fbs.fb_scan_fwd_plain(wf, col, pinit, lp)),
            ("fb_scan_bwd", ":121",
             lambda: fbs.fb_scan_bwd(wf, col, lp),
             lambda: fbs.fb_scan_bwd_plain(wf, col, lp)))
    out = []
    for kname, line, kernel, plain in rows:
        out.append({
            "name": kname, "route": "cuda",
            "source": "vbx_tpu_torch/csrc/fb_scan_tbs.cu",
            "replaces": f"vbx_tpu/ops/fb_pallas.py{line}", "launches": None,
            "max_abs_err": max(v for c in checks[kname].values()
                               for n, v in c.items() if n != "shape"),
            "ms": _cuda_ms(kernel), "plain_ms": _host_ms(plain),
            **scan_bound(T, B, S, kname),
            # no single PyTorch call computes these recursions
            "library_ms": None,
            "checks": checks[kname], "shape": [T, B, S]})
    out[0]["cross"] = cross
    out[0]["two_pass_ms"] = _cuda_ms(both_passes)
    out[0]["batch_invariance"] = scan_batch_invariance(ab)
    return out


def scan_bound(T, B, S, kernel) -> dict:
    """The least time the card could take for one call of K3
    (fb_scan_fused), K4 (fb_scan_fwd) or K5 (fb_scan_bwd) on float32 [T, B,
    S] weights: w and col (and pinit) read once, ahat / bhat (and cfw [T,
    B]) written once; ~12 float32 operations per (frame, lane, speaker) for
    the two chains, ~6 for one. scripts/kernel_bounds.py computes the same
    from the shapes alone."""
    tbs, bs, tb = T * B * S * 4, B * S * 4, T * B * 4
    nbytes, ops = {"fb_scan_fused": (3 * tbs + 2 * bs, 12),
                   "fb_scan_fwd": (2 * tbs + 2 * bs + tb, 6),
                   "fb_scan_bwd": (2 * tbs + bs, 6)}[kernel]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops * T * B * S / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def scan_batch_invariance(case) -> dict:
    """K3, K4 and K5: lanes of one launch against the same lanes launched
    alone and among other neighbours (at another place in the batch);
    every output (K4's cfw too) must be bit-equal, because the group that
    holds a lane depends on S only and a warp's lanes never exchange
    values."""
    import torch

    from vbx_tpu_torch.ops import fb_scan_kernel as fbs

    wf, col, pinit, lp = case["wf"], case["col"], case["pinit"], case["lp"]
    B = wf.shape[1]

    def run(idx):
        w, c = wf[:, idx].contiguous(), col[idx].contiguous()
        p = pinit[idx].contiguous()
        return (*fbs.fb_scan_fused(w, c, p, lp), *fbs.fb_scan_fwd(w, c, p, lp),
                fbs.fb_scan_bwd(w, c, lp))

    full = run(slice(None))
    lanes = sorted({0, 1, B // 2 + 2, B - 1})
    for i in lanes:
        alone = run(slice(i, i + 1))
        among = run(torch.tensor([(7 * i + 3) % B, i, (i + 101) % B, 5 % B,
                                  (B - 6) % B], device="cuda"))
        torch.cuda.synchronize()
        for name, f, a, m in zip(("fb_scan_fused ahat", "fb_scan_fused bhat",
                                  "fb_scan_fwd ahat", "fb_scan_fwd cfw",
                                  "fb_scan_bwd bhat"), full, alone, among):
            if not (torch.equal(f[:, i], a[:, 0])
                    and torch.equal(f[:, i], m[:, 1])):
                fail(f"{name} of lane {i} in a batch of {B} differs from the "
                     f"lane launched alone or among other neighbours")
    return {"lanes": lanes, "batch": B, "bit_equal": True}


def wide_ms() -> dict:
    """The several-warp instance (S > 256) at the bench's B and T: kernel
    time and its bytes bound, float32 streams."""
    import torch

    from vbx_tpu_torch.ops import fb_kernel

    B, T, S = BENCH["B"], BENCH["T"], 300
    case = kernel_case(B, T, S, torch.float32, "one", seed=99)
    args = (case["w"], case["col"], case["pinit"], case["binit"], case["lp"])
    ms = _cuda_ms(lambda: fb_kernel.fb_fused_sb(*args, recip=True))
    return {"shape": [B, T, S], "ms": ms,
            "bound_ms": k1_bound(B, T, S, 4)["bound_ms"]}


def diarize(corpus, out_dir, config, device, fb_impl=None, mesh=None):
    from vbx_tpu_torch.engine.pipeline import diarize_ark

    return diarize_ark(corpus["ark"], corpus["segments"], out_dir, config,
                       corpus["plda"], corpus["transform"], batch=True,
                       verbose=False, fb_impl=fb_impl, device=device,
                       mesh=mesh)


def corpus_agreement(truth, outputs) -> float:
    from vbx_tpu_torch.testing import frame_agreement

    frames = agree = 0
    for rec, ref in truth.items():
        frames += len(ref)
        agree += len(ref) * frame_agreement(ref, outputs[rec].labels1st)
    return agree / frames


def main_path(work: str) -> dict:
    import torch

    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.engine.pipeline import resolve_fb_impl
    from vbx_tpu_torch.ops import fb_kernel
    from vbx_tpu_torch.testing import write_corpus

    t0 = time.perf_counter()
    corpus = smoke_corpus(work)
    out = {"corpus": {"recordings": N_RECORDINGS,
                      "x_vectors": int(sum(len(z) for z in
                                           corpus["truth"].values())),
                      "write_s": time.perf_counter() - t0},
           "files": corpus}
    cuda = torch.device("cuda")
    runs = (("f32", get_preset("example"), "pallas"),
            ("bf16", get_preset("callhome"), None))
    for tag, cfg, fb_impl in runs:
        resolved = resolve_fb_impl(fb_impl, cfg, cuda)
        want = "pallas" if tag == "f32" else "pallas_bf16"
        if resolved != want:
            fail(f"{cfg.name} resolved to {resolved!r}, expected {want!r}")
        rttm_dir = os.path.join(work, f"rttm_{tag}")
        fb_kernel.fb_fused_sb.launches = 0
        t0 = time.perf_counter()
        res = diarize(corpus, rttm_dir, cfg, "cuda", fb_impl)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = fb_kernel.fb_fused_sb.launches
        written = sorted(os.listdir(rttm_dir))
        if len(written) != N_RECORDINGS or len(res) != N_RECORDINGS:
            fail(f"{tag}: {len(written)} RTTMs written, {len(res)} results "
                 f"for {N_RECORDINGS} recordings")
        if launches < 1:
            fail(f"{tag}: the main path launched fb_fused_sb {launches} "
                 f"times")
        agree = corpus_agreement(corpus["truth"], res)
        if not agree >= 0.95:
            fail(f"{tag}: frame agreement with the synthetic truth {agree}")
        out[tag] = {"preset": cfg.name, "fb_impl": resolved,
                    "launches": launches, "cold_s": secs,
                    "agreement_vs_truth": agree,
                    "iters": [int(o.n_iters) for o in res.values()],
                    "speakers_found": sum(o.n_speakers for o in res.values()),
                    "speakers_true": int(sum(len(set(z.tolist())) for z in
                                             corpus["truth"].values()))}
    # warm rerun of the f32 path: e2e seconds per recording
    t0 = time.perf_counter()
    diarize(corpus, os.path.join(work, "rttm_warm"), get_preset("example"),
            "cuda", "pallas")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out["warm_e2e_s"] = secs
    out["warm_e2e_s_per_recording"] = secs / N_RECORDINGS
    # a small corpus on the CPU's structured engine (the reference route)
    small = write_corpus(os.path.join(work, "small"), 8, [300, 450, 600, 380],
                         [2, 3, 4, 3])
    ref = diarize(small, os.path.join(work, "small_cpu"),
                  get_preset("example"), "cpu")
    got = diarize(small, os.path.join(work, "small_cuda"),
                  get_preset("example"), "cuda", "pallas")
    agree = corpus_agreement({r: o.labels1st for r, o in ref.items()}, got)
    if not agree >= 0.995:
        fail(f"kernel route vs CPU structured route: frame agreement {agree}")
    out["small_kernel_vs_cpu_structured_agreement"] = agree
    return out


def bench_vb_args():
    """Synthetic VB inputs at the bench shape on the card (cluster-
    structured features as tests/oracle.py:random_vb_problem makes them):
    [X, phi, gamma, pi, frame_mask, speaker_mask]."""
    import numpy as np
    import torch

    B, T, S, D = BENCH["B"], BENCH["T"], BENCH["S"], BENCH["D"]
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((B, S, D)) * 2.0
    z = rng.integers(0, S, size=(B, T))
    X = centers[np.arange(B)[:, None], z] + rng.standard_normal((B, T, D))
    phi = rng.uniform(0.5, 5.0, size=D)
    gamma = rng.dirichlet(np.ones(S), size=(B, T))
    args = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
            for a in (X, phi, gamma, np.full((B, S), 1.0 / S))]
    return args + [torch.ones((B, T), dtype=torch.bool, device="cuda"),
                   torch.ones((B, S), dtype=torch.bool, device="cuda")]


BENCH_VB_KW = dict(loop_prob=0.99, Fa=0.3, Fb=17.0, max_iters=40,
                   epsilon=1e-6, device="cuda")


def smoke_corpus(work: str):
    """The main path's synthetic corpus (seed 7, N_RECORDINGS recordings,
    T 500-2000, 2-6 speakers)."""
    import numpy as np

    from vbx_tpu_torch.testing import write_corpus

    rng = np.random.default_rng(7)
    lengths = rng.integers(500, 2001, N_RECORDINGS)
    speakers = rng.integers(2, 7, N_RECORDINGS)
    return write_corpus(os.path.join(work, "corpus"), 7, lengths, speakers)


def vb_throughput(fb_impl: str) -> dict:
    """vbx_batched alone at the bench shape, to convergence (max 40)."""
    import torch

    from vbx_tpu_torch.engine.vbhmm import vbx_batched

    B, T, S, D = BENCH["B"], BENCH["T"], BENCH["S"], BENCH["D"]
    args = bench_vb_args()
    kw = dict(BENCH_VB_KW, fb_impl=fb_impl)
    vbx_batched(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = vbx_batched(*args, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not torch.isfinite(res.gamma).all():
        fail(f"vbx_batched({fb_impl}) produced non-finite gamma")
    iters = int(res.n_iters.max())
    return {"fb_impl": fb_impl, "shape": [B, T, S, D], "seconds": secs,
            "max_iters_run": iters, "ms_per_iter": secs / iters * 1e3,
            "rec_per_s": B / secs}


def _stop_after_first_call(module, name):
    """Context manager: module.<name> raises KeyboardInterrupt from its
    second call on (a simulated stop after a checkpointed run's first
    slice)."""
    real = getattr(module, name)
    calls = {"n": 0}

    def dying(*a, **k):
        calls["n"] += 1
        if calls["n"] > 1:
            raise KeyboardInterrupt("simulated stop")
        return real(*a, **k)

    @contextlib.contextmanager
    def patched():
        setattr(module, name, dying)
        try:
            yield
        finally:
            setattr(module, name, real)

    return patched()


def checkpointed_resume(tag, ck, unsliced, sliced, module, name) -> dict:
    """Run `sliced(ck)` (a vbx_batched_checkpointed call writing to file
    ck) with a simulated stop after its first slice, rerun it so that it
    resumes from the file, and hold the result to `unsliced()` bit for bit:
    n_iters, gamma and the ELBO trace. The file must exist after the stop
    and be gone at the end."""
    import numpy as np
    import torch

    ref = unsliced()
    torch.cuda.synchronize()
    with _stop_after_first_call(module, name):
        try:
            sliced(ck)
        except KeyboardInterrupt:
            pass
        else:
            fail(f"{tag}: the run converged inside its first slice; "
                 f"nothing was resumed")
    if not os.path.exists(ck):
        fail(f"{tag}: no checkpoint file after the stop")
    with np.load(ck) as f:
        header = {"fb_impl": str(f["fb_impl"]), "dtype": str(f["dtype"]),
                  "it_done": int(f["it_done"])}
    t0 = time.perf_counter()
    out = sliced(ck)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if os.path.exists(ck):
        fail(f"{tag}: the checkpoint file is still there after completion")
    diffs = {
        "n_iters": int((out.n_iters.cpu() != ref.n_iters.cpu()).sum()),
        "gamma_max_abs": float((out.gamma - ref.gamma.to(out.gamma.device))
                               .abs().max()),
        "elbo_differs": not np.array_equal(
            out.elbo.cpu().numpy(), ref.elbo.cpu().numpy(), equal_nan=True)}
    if diffs["n_iters"] or diffs["gamma_max_abs"] != 0.0 \
            or diffs["elbo_differs"]:
        fail(f"{tag}: the resumed sliced run is not bit-equal to the "
             f"unsliced run: {diffs}")
    return {**header, "resume_s": secs,
            "n_iters": [int(n) for n in ref.n_iters.cpu()[:8]],
            "max_n_iters": int(ref.n_iters.max()), "bit_equal": True}


def corpus_diagnostics(work: str, corpus, sys_rttm_dir: str) -> dict:
    """The diagnostics that run on the main path's corpus: the debug oracle
    on its first recording, and the scorer over the main path's RTTMs."""
    import numpy as np

    from vbx_tpu_torch.cli.score import main as score_main
    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.engine.debug import frame_der, vbx_debug
    from vbx_tpu_torch.engine.pipeline import Diarizer
    from vbx_tpu_torch.io.ark import group_by_recording, iter_vec_ark
    from vbx_tpu_torch.testing import write_truth_rttms

    cfg = get_preset("example")
    diar = Diarizer.from_files(cfg, corpus["plda"], corpus["transform"],
                               device="cuda")
    rec, _, x_raw = next(iter(group_by_recording(
        iter_vec_ark(corpus["ark"]))))
    truth = corpus["truth"][rec]
    x = diar.transform_xvectors(x_raw)
    fea, phi, q0 = diar.vb_inputs(x, diar.initial_labels(x))
    S = q0.shape[1]
    q, _, trace = vbx_debug(
        fea.astype(np.float32), phi[:cfg.lda_dim].astype(np.float32),
        q0.astype(np.float32), np.full(S, 1.0 / S, np.float32),
        ref_labels=truth, loop_prob=cfg.vb.loop_prob, Fa=cfg.vb.Fa,
        Fb=cfg.vb.Fb, max_iters=cfg.vb.max_iters, epsilon=cfg.vb.epsilon,
        device="cuda")
    elbo = np.array([t.elbo for t in trace])
    # float32 roundoff of an ELBO that sums T per-frame terms
    slack = 1e-5 * np.abs(elbo[1:])
    if not (np.isfinite(elbo).all() and np.isfinite(q).all()
            and (np.diff(elbo) >= -slack).all()):
        fail(f"vbx_debug on {rec}: ELBO trace not finite or decreasing "
             f"past float32 roundoff: {elbo.tolist()}")
    out = {"debug": {"recording": rec, "frames": len(truth), "speakers": S,
                     "iters": len(trace), "elbo_first": float(elbo[0]),
                     "elbo_last": float(elbo[-1]),
                     "expected_der": trace[-1].der,
                     "frame_der": frame_der(q, truth, expected=False),
                     "xent": trace[-1].xent}}

    truth_dir = os.path.join(work, "rttm_truth")
    write_truth_rttms(truth_dir, corpus["truth"])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = score_main(["-r", os.path.join(truth_dir, "*.rttm"),
                         "-s", os.path.join(sys_rttm_dir, "*.rttm"),
                         "--collar", "0.25"])
    lines = text.getvalue().splitlines()
    if rc != 0 or len(lines) != 2 or not lines[-1].startswith("*** OVERALL"):
        fail(f"cli/score.py returned {rc} and printed {lines}")
    out["score"] = {"header": lines[0], "overall": lines[1]}
    return out


def assoc_check() -> dict:
    """forward_backward_assoc against forward_backward_structured at
    T=1025, S=31 on the card, float64 and float32."""
    import torch

    from vbx_tpu_torch.ops.forward_backward import (
        forward_backward_assoc, forward_backward_structured)

    T, S = BENCH["T"], BENCH["S"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    log_p = 3.0 * torch.randn((T, S), generator=gen, device="cuda",
                              dtype=torch.float64) - 30
    pi = torch.rand((S,), generator=gen, device="cuda", dtype=torch.float64)
    pi /= pi.sum()
    out = {"shape": [T, S]}
    for dtype, bar in ((torch.float64, 1e-9), (torch.float32,
                                                ASSOC_F32_BAR)):
        a = forward_backward_assoc(log_p.to(dtype), pi.to(dtype), 0.99)
        s = forward_backward_structured(log_p.to(dtype), pi.to(dtype), 0.99)
        torch.cuda.synchronize()
        err = {"gamma": float((a.gamma - s.gamma).abs().max()),
               "log_px_rel": float((a.log_px - s.log_px).abs()
                                   / s.log_px.abs()),
               "pi_stat_over_max": float((a.pi_stat - s.pi_stat).abs().max()
                                         / s.pi_stat.max())}
        if not (err["gamma"] <= bar and err["log_px_rel"] <= 1e-5
                and err["pi_stat_over_max"] <= bar):
            fail(f"forward_backward_assoc vs structured at T={T}, S={S}, "
                 f"{dtype}: {err} past {bar}")
        out[str(dtype).replace("torch.", "")] = err
    return out


def resnet_flops(feat_dim: int, frames: int) -> int:
    """Multiply-adds x 2 of resnet101's convolutions and embedding for one
    [feat_dim, frames] window, from its layer shapes (meta device: no
    weights, no work)."""
    import torch

    from vbx_tpu_torch.models.resnet import resnet101

    with torch.device("meta"):
        model = resnet101(feat_dim)
    total = [0]

    def count(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            total[0] += (2 * out.numel() * mod.in_channels // mod.groups
                         * mod.kernel_size[0] * mod.kernel_size[1])
        else:
            total[0] += 2 * out.numel() * mod.in_features

    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            mod.register_forward_hook(count)
    with torch.no_grad():
        model(torch.zeros(1, feat_dim, frames, device="meta"))
    return total[0]


def fbank_cost(n_samples: int, frames: int, fs: int) -> dict:
    """Operations and bytes of fbank + CMVN over a recording's frames:
    per frame ~2.5 n log2 n for the real FFT of n = nfft points, the mel
    product (2 x bins x 64), ~10 per sample of framing, mean, pre-emphasis,
    window and power, and ~8 per feature of log and CMVN; bytes: the
    float32 signal read once and the features written once."""
    from vbx_tpu_torch.models.features import fbank_config, htk_nfft

    _, mx, winlen, _ = fbank_config(fs)
    nfft = htk_nfft(winlen)
    per_frame = (2.5 * nfft * (nfft.bit_length() - 1) + 2 * mx.size
                 + 10 * winlen + 8 * mx.shape[1])
    return {"ops": frames * per_frame,
            "bytes": 4 * n_samples + 4 * frames * mx.shape[1]}


def _cos(a, b):
    import numpy as np

    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def extraction_path(work: str) -> dict:
    """Phase 7: wav + VAD -> fbank/CMVN -> ResNet101 -> ark + segments on
    the card (see the module docstring)."""
    import numpy as np
    import torch

    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.device import full_fp32_matmuls
    from vbx_tpu_torch.engine.extractor import (XVectorExtractor,
                                                extract_to_ark)
    from vbx_tpu_torch.engine.pipeline import diarize_ark
    from vbx_tpu_torch.io.ark import read_vec_ark
    from vbx_tpu_torch.io.vad import read_lab
    from vbx_tpu_torch.io.wav import read_wav
    from vbx_tpu_torch.models.resnet import (BasicBlock, ResNetXVector,
                                             resnet101)
    from vbx_tpu_torch.ops import fb_kernel
    from vbx_tpu_torch.testing import (synth_models, write_audio_corpus,
                                       write_plda, write_transform)

    t_phase = time.perf_counter()
    fs = EXTRACT_FS
    audio = os.path.join(work, "audio")
    names, wavs, labs = write_audio_corpus(audio, 13, EXTRACT_SECONDS, fs)
    out = {"write_s": time.perf_counter() - t_phase}

    # ResNet101 at full width and depth, seeded default init; the
    # embedding bias is zeroed so that the x-vectors carry the pooled
    # statistics rather than a shared offset
    torch.manual_seed(0)
    f32 = resnet101(64, 256)
    torch.nn.init.zeros_(f32.embedding.bias)
    bf16 = resnet101(64, 256, dtype=torch.bfloat16)
    bf16.load_state_dict(f32.state_dict())
    cpu_model = ResNetXVector(BasicBlock, (1, 1, 1, 1), m_channels=2,
                              feat_dim=64, embed_dim=256)
    f32_cpu = resnet101(64, 256)
    f32_cpu.load_state_dict(f32.state_dict())
    ex = {"f32": XVectorExtractor(f32, fs, batch_size=EXTRACT_BATCH,
                                  device="cuda"),
          "bf16": XVectorExtractor(bf16, fs, batch_size=EXTRACT_BATCH,
                                   device="cuda"),
          "cpu": XVectorExtractor(cpu_model, fs, batch_size=EXTRACT_BATCH,
                                  device="cpu")}

    # windows each recording must give: the CPU's features and windowing
    signals = [read_wav(w)[0] for w in wavs]
    vads = [read_lab(lab) for lab in labs]
    with torch.inference_mode():
        want = {n: len(ex["cpu"].windows(ex["cpu"].features(s, v), n)[2])
                for n, s, v in zip(names, signals, vads)}
    total_windows = sum(want.values())
    audio_s = float(sum(EXTRACT_SECONDS))

    runs = {}
    for tag in ("f32", "bf16", "cpu"):
        for attempt in (("cold", "warm") if tag != "cpu" else ("cold",)):
            ark = os.path.join(work, f"{tag}.ark")
            seg = os.path.join(work, f"{tag}.seg")
            t0 = time.perf_counter()
            counts = extract_to_ark(wavs, labs, names, ark, seg, ex[tag])
            if tag != "cpu":
                torch.cuda.synchronize()
            runs.setdefault(tag, {})[f"{attempt}_s"] = \
                time.perf_counter() - t0
        if counts != want:
            fail(f"extraction [{tag}]: x-vectors per recording {counts}, "
                 f"windows {want}")
        runs[tag]["ark"] = read_vec_ark(ark)
        runs[tag]["segments"] = open(seg).read()
    for tag in ("f32", "bf16"):
        if list(runs[tag]["ark"]) != list(runs["cpu"]["ark"]):
            fail(f"extraction [{tag}]: keys differ from the CPU run's")
        if runs[tag]["segments"] != runs["cpu"]["segments"]:
            fail(f"extraction [{tag}]: segments (keys, times) differ from "
                 f"the CPU run's")
    a = np.stack(list(runs["f32"]["ark"].values()))
    b = np.stack(list(runs["bf16"]["ark"].values()))
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        fail("extraction: non-finite x-vectors")
    bf16_cos = _cos(a, b)
    if not bf16_cos.min() > EXTRACT_BF16_COS:
        fail(f"extraction: bfloat16 vs float32 cosine {bf16_cos.min()}")
    for tag in ("f32", "bf16"):
        out[tag] = {"cold_s": runs[tag]["cold_s"],
                    "warm_s": runs[tag]["warm_s"],
                    "audio_s_per_s": audio_s / runs[tag]["warm_s"]}
    out["cpu_s"] = runs["cpu"]["cold_s"]
    out["windows"] = total_windows
    out["bf16_vs_f32_cos_min"] = float(bf16_cos.min())

    # features, card vs CPU, on recording 0
    with torch.inference_mode():
        fc = ex["f32"].features(signals[0], vads[0])
        fh = ex["cpu"].features(signals[0], vads[0])
    if fc.segments != fh.segments:
        fail("features: segment tables differ between card and CPU")
    feat_err = float((fc.stream.cpu() - fh.stream).abs().max())
    if not feat_err <= FEATURE_F32_BAR:
        fail(f"features: card vs CPU max abs error {feat_err}")
    out["feature_err"] = feat_err

    # 16 windows of recording 0: its first 14 full ones and tails of 10
    # and 77 frames, the card's float32 model against the same model on
    # the CPU on the same windows, and the tails padded against their true
    # length
    starts, lens0, meta0 = ex["f32"].windows(fc, names[0])
    full = [i for i, n in enumerate(lens0) if n == 144][:14]
    if len(full) < 14:
        fail(f"extraction: recording 0 has {len(full)} full windows")
    st = torch.tensor([starts[i] for i in full] + starts[20:22],
                      device="cuda")
    ln = torch.tensor([144] * 14 + [10, 77], device="cuda")
    with torch.inference_mode(), full_fp32_matmuls():
        card = ex["f32"].embed_batch(fc.stream, st, ln).cpu().numpy()
        ar = torch.arange(144, device="cuda")
        win = fc.stream[st[:, None] + ar[None, :]].transpose(1, 2)
        alone = np.stack([f32(win[i:i + 1, :, :int(ln[i])].contiguous())
                          [0].cpu().numpy() for i in (14, 15)])
        cpu = f32_cpu((win * (ar < ln[:, None])[:, None, :]).cpu(),
                      lengths=ln.cpu()).numpy()
    cos = _cos(card, cpu)
    err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    if not (cos.min() >= EXTRACT_F32_COS and err <= EXTRACT_F32_ERR):
        fail(f"float32 card vs CPU on 16 windows: cosine {cos.min()}, "
             f"max abs error / max {err}")
    pad_err = float(np.abs(card[14:] - alone).max() / np.abs(alone).max())
    if not pad_err <= EXTRACT_F32_ERR:
        fail(f"padded tail windows vs true-length runs: {pad_err}")
    # the timed path's own output: extract_to_ark's x-vectors of the same
    # 14 full windows (gathered in its unmasked full batches) against the
    # CPU's
    ark14 = np.stack([runs["f32"]["ark"][meta0[i][0]] for i in full])
    ark_cos = _cos(ark14, cpu[:14])
    ark_err = float(np.abs(ark14 - cpu[:14]).max() / np.abs(cpu[:14]).max())
    if not (ark_cos.min() >= EXTRACT_F32_COS and ark_err <= EXTRACT_F32_ERR):
        fail(f"float32 ark vs CPU on 14 windows: cosine {ark_cos.min()}, "
             f"max abs error / max {ark_err}")
    out.update(card_vs_cpu_cos_min=float(cos.min()), card_vs_cpu_err=err,
               padded_vs_true_err=pad_err,
               ark_vs_cpu_cos_min=float(ark_cos.min()), ark_vs_cpu_err=ark_err)

    # timing: one batch of 128 full windows of recording 0, and fbank +
    # CMVN of one recording, median by CUDA events after a warm-up
    flops = resnet_flops(64, 144) * EXTRACT_BATCH
    st = torch.tensor([starts[i % len(starts)] for i in
                       range(EXTRACT_BATCH)], device="cuda")
    timing = {}
    for tag, peak in (("f32", F32_OPS_PER_S), ("bf16", BF16_OPS_PER_S)):
        # a batch of full windows, as extract_file runs one: no mask
        with torch.inference_mode(), full_fp32_matmuls():
            ms = _cuda_ms(lambda: ex[tag].embed_batch(fc.stream, st), n=10)
        timing[tag] = {"ms_per_batch": ms,
                       "windows_per_s": EXTRACT_BATCH / ms * 1e3,
                       "audio_s_per_s": EXTRACT_BATCH * 0.24 / ms * 1e3,
                       "tflop_per_s": flops / ms / 1e9,
                       "bound_ms": flops / peak * 1e3}
    frames = sum(n for _, _, n in fc.segments)
    cost = fbank_cost(len(signals[0]), frames, fs)
    dithered = ex["f32"].dither(signals[0])
    with torch.inference_mode():
        ms = _cuda_ms(lambda: ex["f32"].dithered_features(dithered,
                                                          vads[0]), n=5)
        with_dither = _host_ms(lambda: ex["f32"].features(signals[0],
                                                          vads[0]), n=3)

        def cold_plans():
            # a recording's segment groups have shapes of their own, so a
            # new recording makes cuFFT plans: time a call that makes them
            torch.backends.cuda.cufft_plan_cache.clear()
            ex["f32"].dithered_features(dithered, vads[0])
        cold = _host_ms(cold_plans, n=3)
    timing["fbank_cmvn"] = {
        "ms_per_recording": ms, "frames": frames,
        "ms_per_128_windows": ms * EXTRACT_BATCH / want[names[0]],
        "tflop_per_s": cost["ops"] / ms / 1e9,
        "with_host_dither_ms": with_dither, "cold_fft_plans_ms": cold,
        "audio_s_per_s": EXTRACT_SECONDS[0] / ms * 1e3,
        "windows_per_s": want[names[0]] / ms * 1e3,
        "bound_ms": max(cost["ops"] / F32_OPS_PER_S,
                        cost["bytes"] / HBM_BYTES_PER_S) * 1e3,
        "bound_by": ("operations" if cost["ops"] / F32_OPS_PER_S
                     > cost["bytes"] / HBM_BYTES_PER_S else "bytes")}
    out["timing"] = timing
    out["flop_per_batch"] = flops

    # audio -> RTTM: the float32 ark through diarize_ark on the card
    (mu, tr, psi), (mean1, lda, mean2) = synth_models(
        np.random.default_rng(17), n_speakers=120)
    plda_path = os.path.join(work, "x_plda")
    transform_path = os.path.join(work, "x_transform.h5")
    write_plda(plda_path, mu, tr, psi)
    write_transform(transform_path, mean1, lda, mean2)
    rttm_dir = os.path.join(work, "x_rttm")
    fb_kernel.fb_fused_sb.launches = 0
    t0 = time.perf_counter()
    res = diarize_ark(os.path.join(work, "f32.ark"),
                      os.path.join(work, "f32.seg"), rttm_dir,
                      get_preset("example"), plda_path, transform_path,
                      verbose=False, fb_impl="pallas", device="cuda")
    torch.cuda.synchronize()
    written = sorted(os.listdir(rttm_dir))
    if written != sorted(f"{n}.rttm" for n in names) or len(res) != len(names):
        fail(f"audio -> RTTM: wrote {written} for {names}")
    if fb_kernel.fb_fused_sb.launches < 1:
        fail("audio -> RTTM: the kernel route launched fb_fused_sb 0 times")
    out["rttm"] = {"s": time.perf_counter() - t0,
                   "k1_launches": fb_kernel.fb_fused_sb.launches,
                   "speakers": [int(res[n].n_speakers) for n in names]}
    out["seconds"] = time.perf_counter() - t_phase
    return out


def diagnostics_path(work: str) -> dict:
    """The kernel A/B and diagnostics path at full width (module
    docstring, phase 6)."""
    import vbx_tpu_torch.engine.vbhmm as vbhmm
    from vbx_tpu_torch.ops import fb_kernel
    from vbx_tpu_torch.ops import fb_scan_kernel as fbs

    spec = importlib.util.spec_from_file_location(
        "torch_ab_fb_kernels",
        os.path.join(HERE, "scripts", "torch_ab_fb_kernels.py"))
    ab_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab_tool)
    counters = {"fb_scan_fused": fbs.fb_scan_fused,
                "fb_scan_fwd": fbs.fb_scan_fwd,
                "fb_scan_bwd": fbs.fb_scan_bwd,
                "fb_fused_sb": fb_kernel.fb_fused_sb}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    ab = ab_tool.main([])
    out = {"ab": ab, "ab_s": time.perf_counter() - t0,
           "launches": {n: fn.launches for n, fn in counters.items()}}
    idle = [n for n, k in out["launches"].items() if k < 1]
    if idle:
        fail(f"the A/B tool launched {idle} no time")
    if not (ab["gamma_maxdiff"] <= 2e-5 and ab["lognorm_maxdiff"] <= 1e-5):
        fail(f"A/B tool: fused vs two-pass differ: {ab}")

    args = bench_vb_args()
    kw = dict(BENCH_VB_KW, fb_impl="pallas")
    fb_kernel.fb_fused_sb.launches = 0
    out["checkpointed"] = checkpointed_resume(
        "vbx_batched_checkpointed at the bench shape",
        os.path.join(work, "vb_state.npz"),
        lambda: vbhmm.vbx_batched(*args, **kw),
        lambda ck: vbhmm.vbx_batched_checkpointed(
            *args, **kw, iters_per_slice=4, checkpoint_path=ck),
        vbhmm, "vbx_batched")
    out["checkpointed"]["k1_launches"] = fb_kernel.fb_fused_sb.launches
    out["assoc"] = assoc_check()
    return out


def mesh_vb_args(corpus, cfg):
    """The mesh corpus's VB inputs as the pipeline pads them (one T_pad
    32768, S_pad 8 bucket), on the card: [X, phi, gamma, pi, frame_mask,
    speaker_mask]."""
    import numpy as np
    import torch

    from vbx_tpu_torch.engine.pipeline import Diarizer
    from vbx_tpu_torch.io.ark import group_by_recording, iter_vec_ark
    from vbx_tpu_torch.utils.bucketing import bucket_shape

    diar = Diarizer.from_files(cfg, corpus["plda"], corpus["transform"],
                               device="cuda")
    prepped = []
    for _, _, x_raw in group_by_recording(iter_vec_ark(corpus["ark"])):
        x = diar.transform_xvectors(x_raw)
        prepped.append(diar.vb_inputs(x, diar.initial_labels(x)))
    T_pad, S_pad = bucket_shape(max(len(q) for _, _, q in prepped),
                                max(q.shape[1] for _, _, q in prepped))
    B, D = len(prepped), prepped[0][0].shape[1]
    X = np.zeros((B, T_pad, D), np.float32)
    G = np.zeros((B, T_pad, S_pad), np.float32)
    PI = np.zeros((B, S_pad), np.float32)
    FM = np.zeros((B, T_pad), bool)
    SM = np.zeros((B, S_pad), bool)
    for b, (fea, _, q) in enumerate(prepped):
        T, S = q.shape
        X[b, :T], G[b, :T, :S] = fea, q
        PI[b, :S], FM[b, :T], SM[b, :S] = 1.0 / S, True, True
    phi = prepped[0][1][:cfg.lda_dim]
    return [torch.as_tensor(a, device="cuda") for a in
            (X, phi.astype(np.float32), G, PI, FM, SM)]


def mesh_em_ms(corpus, cfg, mesh, n_iters: int = 10) -> dict:
    """ms per EM iteration of the sharded engine on `mesh` and of the solo
    engine (kernel route, float32), on the mesh corpus's padded batch, run
    past convergence (epsilon=-inf) for n_iters, in turns mesh, solo, solo,
    mesh after a warm-up of each."""
    import torch

    from vbx_tpu_torch.engine.vbhmm import vbx_batched
    from vbx_tpu_torch.parallel import vbx_sharded

    args = mesh_vb_args(corpus, cfg)
    kw = dict(loop_prob=cfg.vb.loop_prob, Fa=cfg.vb.Fa, Fb=cfg.vb.Fb,
              epsilon=float("-inf"), fb_impl="pallas")
    fns = {"mesh": lambda n: vbx_sharded(mesh, *args, max_iters=n, **kw),
           "solo": lambda n: vbx_batched(*args, max_iters=n, device="cuda",
                                         **kw)}
    for fn in fns.values():
        fn(2)
    times = {"mesh": [], "solo": []}
    for name in ("mesh", "solo", "solo", "mesh"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fns[name](n_iters)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / n_iters * 1e3)
        if not (bool(torch.isfinite(res.gamma).all())
                and bool((res.n_iters == n_iters).all())):
            fail(f"{name} EM at the mesh shape: non-finite gamma or "
                 f"n_iters {res.n_iters.tolist()} != {n_iters}")
    return {"shape": list(args[2].shape) + [args[0].shape[-1]],
            "mesh": mesh.shape, "iters": n_iters,
            "mesh_ms_per_iter": times["mesh"],
            "solo_ms_per_iter": times["solo"]}


def mesh_path(work: str) -> dict:
    """The sharded engine end to end on one card: 1x4 and 2x2 meshes of
    cuda:0 repeated against the solo kernel route (module docstring)."""
    import torch

    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.ops import fb_kernel, fb_product_kernel
    from vbx_tpu_torch.parallel import make_mesh
    from vbx_tpu_torch.testing import write_corpus

    t0 = time.perf_counter()
    corpus = write_corpus(os.path.join(work, "long"), 11, MESH_LENGTHS,
                          [MESH_SPEAKERS] * len(MESH_LENGTHS))
    out = {"corpus": {"lengths": list(MESH_LENGTHS),
                      "speakers": MESH_SPEAKERS,
                      "write_s": time.perf_counter() - t0}}
    cfg = get_preset("example").replace(init=f"random_{MESH_SPEAKERS}+VB")
    cuda0 = torch.device("cuda", 0)
    meshes = {"1x4": make_mesh(1, 4, devices=[cuda0] * 4),
              "2x2": make_mesh(2, 2, devices=[cuda0] * 4)}
    solo = {}
    for where, impl in (("solo", "pallas"), ("1x4", "pallas"),
                        ("2x2", "pallas"), ("solo", "pallas_bf16"),
                        ("1x4", "pallas_bf16")):
        tag = f"{where}_{impl}"
        rttm_dir = os.path.join(work, f"rttm_{tag}")
        fb_kernel.fb_fused_sb.launches = 0
        fb_product_kernel.fb_fwd_product_sb.launches = 0
        t0 = time.perf_counter()
        res = diarize(corpus, rttm_dir, cfg, "cuda", impl,
                      mesh=meshes.get(where))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k1 = fb_kernel.fb_fused_sb.launches
        k2 = fb_product_kernel.fb_fwd_product_sb.launches
        n = len(MESH_LENGTHS)
        if len(os.listdir(rttm_dir)) != n or len(res) != n:
            fail(f"mesh path {tag}: {len(os.listdir(rttm_dir))} RTTMs, "
                 f"{len(res)} results for {n} recordings")
        speakers = [o.n_speakers for o in res.values()]
        if min(speakers) < 2:
            fail(f"mesh path {tag}: speakers found {speakers}")
        if k1 < 1 or (where != "solo" and k2 < 1):
            fail(f"mesh path {tag}: K1 launched {k1} times, K2 {k2} times")
        r = {"fb_impl": impl, "seconds": secs, "k1_launches": k1,
             "k2_launches": k2, "speakers": speakers,
             "iters": [int(o.n_iters) for o in res.values()],
             "agreement_vs_truth": corpus_agreement(corpus["truth"], res)}
        if where == "solo":
            solo[impl] = {rec: o.labels1st for rec, o in res.items()}
        else:
            agree = corpus_agreement(solo[impl], res)
            if not agree >= MESH_AGREE[impl]:
                fail(f"mesh path {tag}: label agreement with the solo "
                     f"route {agree} < {MESH_AGREE[impl]}")
            r["agreement_vs_solo"] = agree
        out[tag] = r
    out["em"] = mesh_em_ms(corpus, cfg, meshes["1x4"])

    # the checkpointed mesh form on the longest recording (one resume)
    import vbx_tpu_torch.engine.vbhmm as vbhmm
    import vbx_tpu_torch.parallel.engine as sharded
    from vbx_tpu_torch.parallel import vbx_sharded

    args = [a[:1] if a.dim() > 1 else a for a in mesh_vb_args(corpus, cfg)]
    kw = dict(loop_prob=cfg.vb.loop_prob, Fa=cfg.vb.Fa, Fb=cfg.vb.Fb,
              max_iters=8, epsilon=float("-inf"), fb_impl="pallas")
    out["checkpointed"] = checkpointed_resume(
        "vbx_batched_checkpointed(mesh=1x4) on the longest recording",
        os.path.join(work, "mesh_state.npz"),
        lambda: vbx_sharded(meshes["1x4"], *args, **kw),
        lambda ck: vbhmm.vbx_batched_checkpointed(
            *args, **kw, iters_per_slice=4, checkpoint_path=ck,
            mesh=meshes["1x4"]),
        sharded, "vbx_sharded")
    return out


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    if not os.path.isdir(os.path.join(HERE, "vbx_tpu_torch", "csrc")):
        fail(f"{HERE} holds no vbx_tpu_torch package: run from a checkout")
    sys.path.insert(0, HERE)
    from vbx_tpu_torch.ops import cuda_build, fb_kernel

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device: {kind}")

    t0 = time.perf_counter()
    ptxas = cuda_build.build(force=True)
    print(f"build: {len(ptxas)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, text in ptxas.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kernels = []
    for io_name in ("float32", "bfloat16"):
        k = kernel_phase(io_name)
        kernels.append(k)
        for name, c in k["checks"].items():
            print(f"kernel {k['name']} vs plain twin at {name} "
                  f"(B,T,S={c['shape']}): {json.dumps(c)}")
        print(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3g}; "
              f"{k['ms']:.4f} ms (median of 25, CUDA events) vs plain twin "
              f"{k['plain_ms']:.1f} ms; bound {k['bound_ms'] * 1e3:.1f} us "
              f"({k['bound_by']}, {k['bytes'] / 1e6:.1f} MB); lanes "
              f"{k['batch_invariance']['lanes']} of the batch of "
              f"{k['batch_invariance']['batch']} bit-equal to the same lanes "
              f"launched alone and among other neighbours")
    long_k1 = long_shape("float32")
    long_bf16 = long_shape("bfloat16")
    print(f"kernel {long_k1['name']} (the solo long recording): "
          f"{json.dumps(long_k1['checks']['long'])}")
    print(f"kernel {long_k1['name']}: {long_k1['ms']:.4f} ms (median of 25) "
          f"vs plain twin {long_k1['plain_ms']:.1f} ms (one run); bound "
          f"{long_k1['bound_ms'] * 1e3:.2f} us ({long_k1['bound_by']}, "
          f"{long_k1['bytes'] / 1e6:.2f} MB); bfloat16 streams "
          f"{long_bf16['ms']:.4f} ms, bound "
          f"{long_bf16['bound_ms'] * 1e3:.2f} us")
    wide = wide_ms()
    print(f"kernel fb_fused_sb[float32], several-warp instance at "
          f"B,T,S={wide['shape']}: {wide['ms']:.4f} ms (median of 25), "
          f"bytes bound {wide['bound_ms'] * 1e3:.1f} us")
    for io_name in ("float32", "bfloat16"):
        k = k2_phase(io_name)
        kernels.append(k)
        for name, c in k["checks"].items():
            print(f"kernel {k['name']} vs plain twin at {name} "
                  f"(B,Tb,S,R={c['shape']}): {json.dumps(c)}")
        print(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3g}; "
              f"{k['ms']:.4f} ms (median of 25, CUDA events) vs plain twin "
              f"{k['plain_ms']:.1f} ms; bound {k['bound_ms'] * 1e3:.2f} us "
              f"({k['bound_by']}, {k['bytes'] / 1e6:.2f} MB) at "
              f"B,Tb,S,R={k['shape']}; a lane's rows bit-equal alone and "
              f"with the lanes in another order at every shape")

    scan = scan_phase()
    for k in scan:
        for name, c in k["checks"].items():
            print(f"kernel {k['name']} vs plain twin at {name} "
                  f"(T,B,S={c['shape']}): {json.dumps(c)}")
        print(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3g}; "
              f"{k['ms']:.4f} ms (median of 25, CUDA events) vs plain twin "
              f"{k['plain_ms']:.1f} ms; bound {k['bound_ms'] * 1e3:.1f} us "
              f"({k['bound_by']}, {k['bytes'] / 1e6:.1f} MB) at "
              f"T,B,S={k['shape']}")
    for name, c in scan[0]["cross"].items():
        print(f"fb_scan cross-checks at {name}: {json.dumps(c)}")
    inv = scan[0]["batch_invariance"]
    print(f"fb_scan_fused, fb_scan_fwd and fb_scan_bwd: lanes "
          f"{inv['lanes']} of the batch of {inv['batch']} bit-equal to the "
          f"same lanes launched alone and among other neighbours; "
          f"fb_scan_fwd's ahat bit-equal to fb_scan_fused's at every shape")
    print(f"fb_scan_fwd then fb_scan_bwd: {scan[0]['two_pass_ms']:.4f} ms "
          f"(median of 25), {scan[0]['two_pass_ms'] / scan[0]['ms']:.2f}x "
          f"fb_scan_fused")

    with tempfile.TemporaryDirectory() as work:
        mp = main_path(work)
        cd = corpus_diagnostics(work, mp["files"],
                                os.path.join(work, "rttm_f32"))
    kernels[0]["launches"] = mp["f32"]["launches"]
    kernels[1]["launches"] = mp["bf16"]["launches"]
    for tag in ("f32", "bf16"):
        r = mp[tag]
        print(f"main path [{tag}, {r['preset']}, {r['fb_impl']}]: "
              f"{N_RECORDINGS} RTTMs, {r['launches']} kernel launches, "
              f"agreement vs truth {r['agreement_vs_truth']:.4f}, "
              f"cold {r['cold_s']:.2f} s")
    print(f"warm e2e: {mp['warm_e2e_s_per_recording']:.4f} s/recording "
          f"({mp['warm_e2e_s']:.2f} s for {N_RECORDINGS}); kernel route vs "
          f"CPU structured route agreement "
          f"{mp['small_kernel_vs_cpu_structured_agreement']:.4f}")

    d = cd["debug"]
    print(f"vbx_debug on {d['recording']} ({d['frames']} frames, "
          f"{d['speakers']} initial speakers, float32 on the card): "
          f"{d['iters']} iterations, ELBO {d['elbo_first']:.2f} -> "
          f"{d['elbo_last']:.2f} non-decreasing, final frame DER "
          f"{d['frame_der']:.4f} (expected DER {d['expected_der']:.4f}, "
          f"cross-entropy {d['xent']:.4f}) against the truth labels")
    print(f"cli/score.py, main path f32 RTTMs vs truth RTTMs, collar 0.25:")
    print(f"  {cd['score']['header']}")
    print(f"  {cd['score']['overall']}")

    for fb_impl in ("pallas", "pallas_bf16"):
        v = vb_throughput(fb_impl)
        print(f"VB {v['fb_impl']} at B,T,S,D={v['shape']}: "
              f"{v['rec_per_s']:.1f} rec/s ({v['max_iters_run']} iters, "
              f"{v['ms_per_iter']:.3f} ms/iter)")

    with tempfile.TemporaryDirectory() as work:
        mp = mesh_path(work)
    kernels[2]["launches"] = mp["1x4_pallas"]["k2_launches"]
    kernels[3]["launches"] = mp["1x4_pallas_bf16"]["k2_launches"]
    # K1 at the long shape: the solo run of the mesh corpus launches it
    long_k1["launches"] = mp["solo_pallas"]["k1_launches"]
    print(f"mesh corpus: {len(MESH_LENGTHS)} recordings of "
          f"{list(MESH_LENGTHS)} x-vectors, {MESH_SPEAKERS} speakers, "
          f"written in {mp['corpus']['write_s']:.1f} s")
    for tag, r in mp.items():
        if tag in ("corpus", "em", "checkpointed"):
            continue
        vs_solo = (f", agreement vs solo {r['agreement_vs_solo']:.4f}"
                   if "agreement_vs_solo" in r else "")
        print(f"mesh path [{tag}]: {r['seconds']:.2f} s, K1 launches "
              f"{r['k1_launches']}, K2 launches {r['k2_launches']}, "
              f"speakers {r['speakers']}, iters {r['iters']}, agreement vs "
              f"truth {r['agreement_vs_truth']:.4f}{vs_solo}")
    em = mp["em"]
    print(f"EM at B,T,S,D={em['shape']} (pallas, {em['iters']} iterations): "
          f"mesh {em['mesh']} {em['mesh_ms_per_iter']} ms/iter, solo "
          f"{em['solo_ms_per_iter']} ms/iter (one card: the mesh's four "
          f"shards run one after another on one stream)")

    ck = mp["checkpointed"]
    print(f"checkpointed mesh form ({ck['fb_impl']}, {ck['dtype']}): stopped "
          f"after {ck['it_done']} iterations, resumed in "
          f"{ck['resume_s']:.2f} s, {ck['max_n_iters']} iterations, "
          f"bit-equal to the unsliced vbx_sharded run, file removed")

    with tempfile.TemporaryDirectory() as work:
        dp = diagnostics_path(work)
    for k in scan:
        k["launches"] = dp["launches"][k["name"]]
    kernels += scan
    kernels.append(long_k1)
    ab = dp["ab"]
    print(f"A/B tool at B,T,S,D={ab['shape']} ({dp['ab_s']:.1f} s): fb_scan "
          f"fused {ab['kernel_fused_ms']:.4f} ms, two-pass "
          f"{ab['kernel_two_pass_ms']:.4f} ms "
          f"({ab['kernel_two_pass_ms'] / ab['kernel_fused_ms']:.2f}x); gamma "
          f"maxdiff {ab['gamma_maxdiff']:.2e}, log-normalizer maxdiff "
          f"{ab['lognorm_maxdiff']:.2e}; EM(10 iterations) kernel route "
          f"{ab['em_pallas_ms']:.1f} ms, structured "
          f"{ab['em_structured_ms']:.1f} ms; launches {dp['launches']}")
    ck = dp["checkpointed"]
    print(f"checkpointed kernel route at the bench shape ({ck['fb_impl']}, "
          f"{ck['dtype']}, 4 iterations per slice): stopped after "
          f"{ck['it_done']}, resumed in {ck['resume_s']:.2f} s, "
          f"{ck['max_n_iters']} iterations at most, {ck['k1_launches']} K1 "
          f"launches, bit-equal to the unsliced vbx_batched run, file "
          f"removed")
    a = dp["assoc"]
    print(f"forward_backward_assoc vs structured at T,S={a['shape']}: "
          f"float64 {json.dumps(a['float64'])}; float32 "
          f"{json.dumps(a['float32'])} (gamma bar {ASSOC_F32_BAR})")

    with tempfile.TemporaryDirectory() as work:
        xp = extraction_path(work)
    print(f"extraction corpus: {len(EXTRACT_SECONDS)} recordings of "
          f"{EXTRACT_SECONDS[0]:.0f} s at {EXTRACT_FS} Hz, {xp['windows']} "
          f"windows, written in {xp['write_s']:.1f} s")
    for tag in ("f32", "bf16"):
        r = xp[tag]
        print(f"extraction [{tag}] extract_to_ark on cuda, batch "
              f"{EXTRACT_BATCH}: cold {r['cold_s']:.2f} s, warm "
              f"{r['warm_s']:.2f} s ({r['audio_s_per_s']:.0f} audio s/s "
              f"warm, wav decode to ark); one x-vector per window, keys and "
              f"segments equal to the CPU run's ({xp['cpu_s']:.1f} s)")
    for tag in ("f32", "bf16"):
        t = xp["timing"][tag]
        print(f"ResNet101 [{tag}] at [{EXTRACT_BATCH}, 64, 144]: "
              f"{t['ms_per_batch']:.3f} ms a batch (median of 10, CUDA "
              f"events), {t['windows_per_s']:.0f} windows/s, "
              f"{t['audio_s_per_s']:.0f} audio s/s at 0.24 s a window, "
              f"{t['tflop_per_s']:.1f} TFLOP/s of "
              f"{xp['flop_per_batch'] / 1e12:.3f} TFLOP a batch; bound "
              f"{t['bound_ms']:.3f} ms (operations)")
    f = xp["timing"]["fbank_cmvn"]
    print(f"fbank + CMVN of one {EXTRACT_SECONDS[0]:.0f} s recording "
          f"({f['frames']} frames): {f['ms_per_recording']:.3f} ms (median "
          f"of 5, CUDA events; {f['with_host_dither_ms']:.1f} ms with the "
          f"host dither, {f['cold_fft_plans_ms']:.1f} ms making its cuFFT "
          f"plans anew), {f['ms_per_128_windows']:.3f} ms per 128 "
          f"windows, {f['audio_s_per_s']:.0f} audio s/s, "
          f"{f['windows_per_s']:.0f} windows/s, {f['tflop_per_s']:.3f} "
          f"TFLOP/s; bound {f['bound_ms'] * 1e3:.1f} us ({f['bound_by']})")
    print(f"extraction checks: features card vs CPU {xp['feature_err']:.3g} "
          f"(bar {FEATURE_F32_BAR}); float32 card vs CPU on 16 windows "
          f"cosine >= {xp['card_vs_cpu_cos_min']:.7f}, max abs error / max "
          f"{xp['card_vs_cpu_err']:.3g}; float32 ark vs CPU on its 14 full "
          f"windows cosine >= {xp['ark_vs_cpu_cos_min']:.7f}, max abs error "
          f"/ max {xp['ark_vs_cpu_err']:.3g}; padded tails vs true length "
          f"{xp['padded_vs_true_err']:.3g}; bfloat16 vs float32 cosine >= "
          f"{xp['bf16_vs_f32_cos_min']:.5f}")
    r = xp["rttm"]
    print(f"audio -> RTTM: {len(r['speakers'])} RTTMs from the extracted "
          f"ark on cuda in {r['s']:.2f} s, K1 launches {r['k1_launches']}, "
          f"speakers {r['speakers']}; phase {xp['seconds']:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kr[k] for k in keys}
                                  for kr in kernels]}))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
