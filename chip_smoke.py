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
   path's largest bucket, and, with skip_dead, a random boundary message
   and all-zero padded frames, the bench shape and the mesh path's shard
   shape B=4, T=8192, S=8), with the tolerances of
   tests/test_torch_fb_kernel.py. K2 (fb_fwd_product_sb) at K2_SHAPES
   (the mesh path's shard shape B=4, Tb=8192, S=8, R=16 with two trailing
   dead segments on one lane; S=31; S=128), with the tolerance of
   tests/test_torch_gpu.py. CUDA-event times (median of 25 launches),
   the twin's time, and the bytes/operations bound;
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
   convergence at the bench shape (D=128) for VB recordings per second;
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
   scaling;
6. one JSON line listing every ported kernel with its numbers;
7. the last line: {"ok": true, "device": {"platform": "gpu", ...}}.

Without a card, or outside a checkout, it exits non-zero before printing
any result.
"""

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
N_RECORDINGS = 64
MESH_LENGTHS = (32768, 30000, 24000, 17000)
MESH_SPEAKERS = 8
# mesh vs solo label agreement bars
MESH_AGREE = {"pallas": 0.995, "pallas_bf16": 0.99}


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
# bench shape and at the mesh path's shard shape.
CHECK_SHAPES = (("S8", 32, 400, 8, "one", False),
                ("S64", 32, 400, 64, "one", False),
                ("S256", 32, 400, 256, "one", False),
                ("S300", 8, 200, 300, "one", False),
                ("S4096", 4, 200, 4096, "one", False),
                ("bucket", 64, 2048, 8, "all", False),
                ("bench_skip_dead", 256, 1025, 31, "one", True),
                ("shard_skip_dead", 4, 8192, 8, "shard", True))


def kernel_case(B, T, S, io, padded, seed, skip_dead=False):
    """random_hmm_problem-like inputs on the card: log-likelihoods, one
    lane with two absent speakers, and padded frames: lane 1 short by T/5
    ('one'); every lane of a random length in [500, T] ('all'); or lane 1
    short by 40% and lane 3 all padding, as shards of a long recording's
    tail are ('shard'). Padded frames are the engine's uniform suffix of
    1/S, or all zero with skip_dead, which also draws a random
    non-uniform boundary message binit (the mesh path's mode)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    log_p = 3.0 * torch.randn((B, T, S), generator=gen, device="cuda") - 30
    smask = torch.ones((B, S), device="cuda")
    gone = min(2, B - 1)
    smask[gone, -2:] = 0
    log_p[gone, :, -2:] = -1e30
    if padded == "all":
        lengths = torch.randint(500, T + 1, (B,), generator=gen,
                                device="cuda")
    else:
        lengths = torch.full((B,), T, device="cuda")
        lengths[1] = T - (T // 5 if padded == "one" else 2 * T // 5)
        if padded == "shard":
            lengths[3] = 0
    valid = (torch.arange(T, device="cuda")[:, None]
             < lengths[None, :]).float()                            # [T, B]
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
    p = fb_kernel.fb_fused_sb_plain(*args, recip=True,
                                    skip_dead=case["skip_dead"])
    torch.cuda.synchronize()

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
        "ahat": (k[0].float() - p[0].float()).abs()[vmask].max().item(),
        "bhat_normalized": (bk - bp).abs()[vmask].max().item(),
        "gamma": (gk - gp).abs().max().item(),
        "cfw_rel": ((k[2] - p[2]).abs() / p[2])[vmask].max().item(),
        "log_px_rel": ((lk - lpp).abs() / lpp.abs().clamp(min=1.0)
                       ).max().item(),
        "pi_stat_over_max": ((pk - pp).abs().max() / pp.abs().max()).item(),
    }
    gtol, ltol, ptol = BARS[io_name]
    bad = [name for name, val, bar in (
        ("ahat", err["ahat"], gtol), ("bhat", err["bhat_normalized"], gtol),
        ("gamma", err["gamma"], gtol), ("cfw", err["cfw_rel"], ltol),
        ("log_px", err["log_px_rel"], ltol),
        ("pi_stat", err["pi_stat_over_max"], ptol)) if not val <= bar]
    return err, bad


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
    # bound: read w once, write ahat/bhat once (stream type) and cfw
    # (f32), read col/pinit/binit (f32); ~12 float32 operations per
    # (lane, frame, speaker) across both chains
    esize = w.element_size()
    bytes_moved = 3 * B * T * S * esize + B * T * 4 + 3 * B * S * 4
    ops = 12 * B * T * S
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"name": f"fb_fused_sb[{io_name}]", "route": "cuda",
            "source": "vbx_tpu_torch/csrc/fb_fused_sb.cu",
            "replaces": "vbx_tpu/ops/fb_pallas.py:198",
            "launches": None,
            "max_abs_err": max(max(c["ahat"], c["bhat_normalized"],
                                   c["gamma"]) for c in checks.values()),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            # no single PyTorch call computes this smoother
            "library_ms": None,
            "checks": checks, "bytes": bytes_moved, "shape": [B, T, S]}


# K2 shapes: (name, B, Tb, S, R). The mesh path's shard shape (a T_pad
# 32768 bucket over 4 'sp' shards: B=4, Tb=8192, S_pad 8, R=16 segments of
# Ts=512 by parallel.fb_blockwise._auto_segments), then S=31 and S=128.
K2_SHAPES = (("shard", 4, 8192, 8, 16), ("S31", 4, 2048, 31, 4),
             ("S128", 2, 1024, 128, 2))


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
        ms = _cuda_ms(lambda: k2.fb_fwd_product_sb(*args))
        plain_ms = _host_ms(lambda: k2.fb_fwd_product_sb_plain(*args))
        # bound: read w, col and finit once, write fhat and ls once; ~5
        # float32 operations per (segment, lane, row, frame, speaker)
        esize = case["w"].element_size()
        bytes_moved = (B * Tb * S * esize + B * S * 4 + 2 * R * B * S * S * 4
                       + R * B * S * 4)
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = 5 * B * Tb * S * S / F32_OPS_PER_S * 1e3
        checks[name] = {"shape": [B, Tb, S, R], **err, "ms": ms,
                        "plain_ms": plain_ms, "bytes": bytes_moved,
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": ("bytes" if t_bytes >= t_ops
                                     else "operations")}
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


def wide_ms() -> dict:
    """The several-warp instance (S > 256) at the bench's B and T: kernel
    time and its bytes bound, float32 streams."""
    import torch

    from vbx_tpu_torch.ops import fb_kernel

    B, T, S = BENCH["B"], BENCH["T"], 300
    case = kernel_case(B, T, S, torch.float32, "one", seed=99)
    args = (case["w"], case["col"], case["pinit"], case["binit"], case["lp"])
    ms = _cuda_ms(lambda: fb_kernel.fb_fused_sb(*args, recip=True))
    bytes_moved = 3 * B * T * S * 4 + B * T * 4 + 3 * B * S * 4
    return {"shape": [B, T, S], "ms": ms,
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3}


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
                      "write_s": time.perf_counter() - t0}}
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
    return out


def main() -> int:
    import torch

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
              f"({k['bound_by']}, {k['bytes'] / 1e6:.1f} MB)")
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
              f"B,Tb,S,R={k['shape']}")

    with tempfile.TemporaryDirectory() as work:
        mp = main_path(work)
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

    for fb_impl in ("pallas", "pallas_bf16"):
        v = vb_throughput(fb_impl)
        print(f"VB {v['fb_impl']} at B,T,S,D={v['shape']}: "
              f"{v['rec_per_s']:.1f} rec/s ({v['max_iters_run']} iters, "
              f"{v['ms_per_iter']:.3f} ms/iter)")

    with tempfile.TemporaryDirectory() as work:
        mp = mesh_path(work)
    kernels[2]["launches"] = mp["1x4_pallas"]["k2_launches"]
    kernels[3]["launches"] = mp["1x4_pallas_bf16"]["k2_launches"]
    print(f"mesh corpus: {len(MESH_LENGTHS)} recordings of "
          f"{list(MESH_LENGTHS)} x-vectors, {MESH_SPEAKERS} speakers, "
          f"written in {mp['corpus']['write_s']:.1f} s")
    for tag, r in mp.items():
        if tag in ("corpus", "em"):
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

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kr[k] for k in keys}
                                  for kr in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
