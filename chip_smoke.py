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
8. device AHC at AHC_D = 128 (8 synthetic speaker clusters): the NN-chain
   walk kernel (csrc/nn_chain.cu) at N = 6144, 10000, 16384 (ms, median of
   3, steps, cycles a step, bound from the rows the walk read) against
   the host float64 chain (linkage_dot_avg, once on all cores and, at 6144
   and 10000, on one thread): sorted merge distances within AHC_PAIRS_BAR
   and labels equal at the AHC cut and two gap-midpoint cuts, each beside
   the two-barrier design's figures (AHC_TWO_BARRIER); the walk's per-step
   floor at N = 256; the
   crossover: the walk at N = 1024 / 2048 / 4096 against the host chain on
   one thread (the same gates); the kernel against its plain twin at
   N = 2048 (the same contract); four lanes (6144 / 8000 / 10000 / 12000)
   in one launch bit-equal to each alone and at one and two blocks an SM;
   the calibration sweeps, single and batched, within AHC_THR_BAR of the
   host blocked sweep, with ms a pass against its bound and the whole
   calibration's seconds against the host sweep's; ahc_labels('auto',
   'cuda') at N = 10000 launching the walk once, no fallback, the 'host'
   labels; and the corpus pre-stage: 4 recordings of PRE_LENGTHS through
   diarize_ark (pre_linkage_recordings == 4, walk launches counted),
   initial labels and RTTMs equal to a compute_backend='host' run;
9. serving: DiarizationService(device='cuda') on the callhome preset (its
   'pallas_bf16' overridden by the serving default 'pallas') over the
   64-recording smoke corpus, submitted from SERVE_THREADS threads: labels
   equal to diarize_ark's, requests/s, p50/p95 latency, batches, K1
   launched; one AMI-length request (AMI_N x-vectors): one walk launch, no
   fallback to the host chain, labels equal to a 'host' service's; the
   HTTP daemon (python -m vbx_tpu_torch.cli.serve on a free local port,
   phase 7's seeded ResNet101 checkpoint): /healthz names cuda and the
   card, an inline, an ark and a wav request answer 200, the corpus ark at
   an admission bound of 1 answers 503, SIGTERM drains it;
10. multi-host corpus runs and the multi-device dryrun: (a) the corpus
   runner (python -m vbx_tpu_torch.cli.run_corpus) runs its diarization
   stage on phase 4's corpus under the callhome preset (K1 in bfloat16)
   once in one process and once in two processes of one gloo group on
   cuda:0 (COORDINATOR_ADDRESS on a free local port, NUM_PROCESSES=2,
   PROCESS_ID), then its score stage against the truth RTTMs after each:
   all.rttm byte-equal, score lines equal, K1 launched; (b) its xvectors
   stage on phase 7's audio with phase 7's seeded ResNet101 checkpoint
   (preset ami_mixheadset, 16 kHz), one process against two: keys and
   segments byte-equal, x-vectors byte-equal or within XV_SPLIT_COS /
   XV_SPLIT_ERR (the line says which); each stage's wall seconds from
   spawn to the last exit, process start-up and CUDA initialization
   included and timed alone; (c) parallel.dryrun.dryrun_multichip over
   every visible card, or over cuda:0 four times (a 2x2 mesh) with one
   card, K1 and K2 launched; (d) with at least two cards, phase 5's mesh
   EM (B=4, T=32768, S=8) on a 1x4 (1x2 with two or three cards) mesh of
   distinct cards beside the same mesh of cuda:0 repeated and the solo
   engine; with one card a line says that (d) did not run and why;
11. bench_torch.py, the port's counterpart of bench.py, as a subprocess
   (BENCH_TIMEOUT): VB at B=256, T=1025, S=31, D=128 from the bench
   recording's init chain, 'pallas' and 'pallas_bf16' under its guard, the
   reference baseline and the warm e2e of phase 4's corpus; its JSON line
   is printed, and the phase fails unless it exits 0 with the bench
   shape, a kernel route as headline_impl, K1 launched, value and
   vs_baseline above 0 and e2e agreement >= 0.95;
12. the measurement drivers of scripts/ (torch_serving_bench.py,
   torch_extractor_bench.py, torch_ami_scale_bench.py,
   torch_linkage_scale_bench.py, torch_scaling_bench.py), each as a
   subprocess on the card (DRIVER_TIMEOUT), at the sizes of DRIVER_RUNS,
   cut from the drivers' full sizes to keep the phase near three minutes:
   serving N = 128 requests from K = 16 threads, and the partial-launch
   ABBA (--ab) at N = 32 (full size N = 256), both on the kernel route
   'pallas' (the example preset's own engine on a card is the structured
   smoother, a host loop of launches a frame: ~40 s of bucket warm-up a
   service); the extractor's precision A/B on 1 minute of audio (full
   size 4); the AMI-scale corpus at full size (18 meetings of 8-11k
   x-vectors) with --check-meetings 2: its first two meetings run again on
   the CPU's structured engine and must agree with the card's labels on
   >= 99% of frames (scripts/ab_corpus_engine.py's bar); the host chain at
   N = 10000, condensed and --ondemand (full size 10k / 20k / 50k);
   scaling at T = 1024 and one timed run a mesh (full size T = 4096, the
   median of 5; one card is cuda:0 repeated 4 times). Each must exit 0
   (its own checks: the serving warm-up's 5 speakers and labels equal to
   diarize_ark's, every mesh's labels >= 99.5% equal to the solo
   engine's) and print its JSON line naming the card; the phase prints
   the drivers' lines and its seconds. The kernels line is unchanged: the
   drivers add no kernel;
13. the A/B drivers of scripts/ (torch_ab_corpus_engine.py,
   torch_ab_plateau.py, torch_ab_ahc_device.py, torch_ab_long_t.py,
   torch_ab_sp_blockwise.py, torch_ab_s_gt_128.py), each as a subprocess
   on the card (DRIVER_TIMEOUT), at the sizes of AB_RUNS, cut from the
   drivers' full sizes to keep the phase near three minutes: the corpus
   engine A/B and the plateau A/B ('pallas_bf16') on 4 meetings of
   1000-2000 x-vectors (full size 18 of 8-11k; at this length every
   meeting's AHC takes the host chain), the corpus rows held to the CPU
   structured run of the first 2; the device AHC at N = 16384 (full size
   50000); the long-T smoothers at T = 8192 (full size 65536); the sp
   forms at T = 8192 on cuda:0 x 4 (full size 32768); S > 128 at
   T = 2000 (full size 10000); one timed run a row (--reps 1; full size
   the median of 3). Each must exit 0 with its own gates (every corpus row
   bounds=OK, thresholds within 5e-5, walk distances within 1e-12 and
   labels equal, 'host' and 'device' AHC labels identical, the sp forms'
   labels at the mesh bars, finite gamma) and print its JSON line naming
   the card and a line matching its AB_RUNS pattern; and every kernel row
   must have moved its kernel's launch counter (each reset just before the
   row's run and read just after, in the driver): K1 in the corpus
   engine's None / 'pallas' / 'pallas_bf16' rows, both plateau rules, the
   solo and sp kernel forms and the S = 128 / 160 / 256 kernel rows; K2 in
   the sp kernel forms; the walk in the AHC driver's linkage. The phase
   prints the drivers' lines, the launches and its seconds; the kernels
   line is unchanged: the drivers add no kernel;
14. one JSON line listing every ported kernel with its numbers, the total
   seconds;
15. the last line: {"ok": true, "device": {"platform": "gpu", ...}}.

Without a card, or outside a checkout, it exits non-zero before printing
any result.
"""

import contextlib
import dataclasses
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
N_RECORDINGS = 64           # vbx_tpu_torch.testing.MAIN_PATH_RECORDINGS
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
# multi-host corpus runs (phase 10): seconds a stage's processes may take;
# the bar for x-vectors of a split xvectors stage that are not byte-equal
# (phase 7's float32 ark against the CPU, as measured on an H100)
STAGE_TIMEOUT = 600
XV_SPLIT_COS = 0.9999999
XV_SPLIT_ERR = 8.9e-7
# bench_torch.py (phase 11): seconds it may take; the e2e agreement bar
BENCH_TIMEOUT = 600
BENCH_E2E_AGREEMENT = 0.95
# the measurement drivers (phase 12): (tag, script and arguments, a line
# of the JAX driver's that its stdout must hold), the seconds one may take,
# and the AMI-scale gate (scripts/ab_corpus_engine.py:8's bar)
DRIVER_RUNS = (
    ("serving", ["torch_serving_bench.py", "128", "16", "pallas"],
     r"^served 128 requests in .* req/s; latency p50="),
    ("serving --ab", ["torch_serving_bench.py", "32", "16", "pallas",
                      "--ab"],
     r"^A/B p95: off \d+ms vs partial \d+ms"),
    ("extractor", ["torch_extractor_bench.py", "1"],
     r"^downstream AHC labels identical: "),
    ("ami_scale", ["torch_ami_scale_bench.py", "--check-meetings", "2"],
     r"^stages: init="),
    ("linkage", ["torch_linkage_scale_bench.py", "10000"],
     r"^N=10000 \[condensed\]: .* -> TOTAL"),
    ("linkage --ondemand", ["torch_linkage_scale_bench.py", "10000",
                            "--ondemand"],
     r"^N=10000 \[ondemand\(O\(N\*D\)\)\]: .* -> TOTAL"),
    ("scaling", ["torch_scaling_bench.py", "--T", "1024", "--reps", "1"],
     r'^\{"platform": "gpu"'),
)
DRIVER_TIMEOUT = 600
AMI_CHECK_AGREEMENT = 0.99
# the A/B drivers (phase 13), as DRIVER_RUNS; cuts in the module docstring
AB_RUNS = (
    ("ab_corpus_engine", ["torch_ab_corpus_engine.py", "4", "--frames",
                          "1000", "2000"],
     r"^pallas_bf16 +wall=.* bounds=OK$"),
    ("ab_plateau", ["torch_ab_plateau.py", "pallas_bf16", "4", "--frames",
                    "1000", "2000", "--reps", "1"],
     r"^batch steps: \d+ -> \d+; identical-label meetings: "),
    ("ab_ahc_device", ["torch_ab_ahc_device.py", "16384"],
     r"^ahc_labels N=16384: .* labels identical: True"),
    ("ab_long_t", ["torch_ab_long_t.py", "8192", "--reps", "1"],
     r"^assoc: median [\d.]+ ms/EM-run"),
    ("ab_sp_blockwise", ["torch_ab_sp_blockwise.py", "8192", "--reps", "1"],
     r"^sp_structured: median .* of solo_pallas_bf16"),
    ("ab_s_gt_128", ["torch_ab_s_gt_128.py", "2000", "--reps", "1"],
     r"^S=160 pallas vs structured label agreement: "),
)


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


def _sync_all() -> None:
    """Wait for every visible card (torch.cuda.synchronize waits only for
    the current one)."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


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


def main_path(work: str) -> dict:
    import torch

    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.engine.pipeline import resolve_fb_impl
    from vbx_tpu_torch.ops import fb_kernel
    from vbx_tpu_torch.testing import (corpus_agreement, main_path_corpus,
                                       write_corpus)

    t0 = time.perf_counter()
    corpus = main_path_corpus(os.path.join(work, "corpus"))
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
    from vbx_tpu_torch.io.ark import read_vec_ark_grouped
    from vbx_tpu_torch.testing import write_truth_rttms

    cfg = get_preset("example")
    diar = Diarizer.from_files(cfg, corpus["plda"], corpus["transform"],
                               device="cuda")
    rec, _, x_raw = next(read_vec_ark_grouped(corpus["ark"]))
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
    from vbx_tpu_torch.io.ark import read_vec_ark_grouped
    from vbx_tpu_torch.utils.bucketing import bucket_shape

    diar = Diarizer.from_files(cfg, corpus["plda"], corpus["transform"],
                               device="cuda")
    prepped = []
    for _, _, x_raw in read_vec_ark_grouped(corpus["ark"]):
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


def mesh_em_ms(corpus, cfg, meshes: dict, n_iters: int = 10) -> dict:
    """ms per EM iteration of the sharded engine on each of `meshes`
    ({name: Mesh}) and of the solo engine (kernel route, float32), on the
    mesh corpus's padded batch, run past convergence (epsilon=-inf) for
    n_iters, in turns (each mesh, solo, solo, each mesh in reverse order)
    after a warm-up of each. Every card is synchronized around a run."""
    import torch

    from vbx_tpu_torch.engine.vbhmm import vbx_batched
    from vbx_tpu_torch.parallel import vbx_sharded

    args = mesh_vb_args(corpus, cfg)
    kw = dict(loop_prob=cfg.vb.loop_prob, Fa=cfg.vb.Fa, Fb=cfg.vb.Fb,
              epsilon=float("-inf"), fb_impl="pallas")
    fns = {name: (lambda n, m=m: vbx_sharded(m, *args, max_iters=n, **kw))
           for name, m in meshes.items()}
    fns["solo"] = lambda n: vbx_batched(*args, max_iters=n, device="cuda",
                                        **kw)
    for fn in fns.values():
        fn(2)
    times = {name: [] for name in fns}
    gammas = {}
    for name in [*meshes, "solo", "solo", *reversed(list(meshes))]:
        _sync_all()
        t0 = time.perf_counter()
        res = fns[name](n_iters)
        _sync_all()
        times[name].append((time.perf_counter() - t0) / n_iters * 1e3)
        if not (bool(torch.isfinite(res.gamma).all())
                and bool((res.n_iters == n_iters).all())):
            fail(f"{name} EM at the mesh shape: non-finite gamma or "
                 f"n_iters {res.n_iters.tolist()} != {n_iters}")
        gammas[name] = res.gamma.cpu()
    return {"shape": list(args[2].shape) + [args[0].shape[-1]],
            "meshes": {name: m.shape for name, m in meshes.items()},
            "devices": {name: sorted({str(d) for row in m.devices
                                      for d in row})
                        for name, m in meshes.items()},
            "iters": n_iters, "ms_per_iter": times, "gamma": gammas}


def mesh_path(work: str) -> dict:
    """The sharded engine end to end on one card: 1x4 and 2x2 meshes of
    cuda:0 repeated against the solo kernel route (module docstring)."""
    import torch

    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.ops import fb_kernel, fb_product_kernel
    from vbx_tpu_torch.parallel import make_mesh
    from vbx_tpu_torch.testing import corpus_agreement, write_corpus

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
    out["em"] = mesh_em_ms(corpus, cfg, {"1x4": meshes["1x4"]})
    del out["em"]["gamma"]

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


# device AHC (phase 8): synthetic cosine AHC inputs, AHC_CLUSTERS speaker
# clusters in AHC_D dims (the presets' lda_dim), at vbx_tpu's measured N
AHC_NS = (6144, 10000, 16384)
AHC_ONE_THREAD_NS = (6144, 10000)
AHC_D = 128
AHC_CLUSTERS = 8
AHC_TWIN_N = 2048
AHC_BATCH_NS = (6144, 8000, 10000, 12000)
AHC_FLOOR_N = 256          # a walk this short shows the per-step floor
AHC_CROSS_NS = (1024, 2048, 4096)   # the walk against the one-thread host
                                    # chain (the init pool's setting)
# the walk's earlier design on this card (two grid barriers a step; PERF.md
# §6, the walk row), printed beside this run's
AHC_TWO_BARRIER = {"ms": {6144: 174.5, 10000: 385.0, 16384: 640.7},
           "us_per_step": {6144: 9.51, 10000: 12.88, 16384: 13.07},
           "floor_us": 10.13, "batched_ms": 880.0}
AHC_PAIRS_BAR = 1e-12      # the float64 walk's sorted merge distances vs
                           # the host chain's and the twin's
AHC_THR_BAR = 5e-5         # device vs host threshold, tests/test_ahc.py
PRE_LENGTHS = (6500, 8000, 10000, 12000)
SM_CLOCK_HZ = 1.98e9       # the H100's SM clock under load (nvidia-smi)
# serving (phase 9)
SERVE_THREADS = 8
AMI_N = 8750               # ~35 minutes of x-vectors at 0.24 s


def ahc_xn(n: int, seed: int, d: int = AHC_D, k: int = AHC_CLUSTERS):
    """[n, d] float64 l2-normalized rows around k centres
    (tests/test_clustering.py's recipe)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d))
    x = centers[rng.integers(0, k, n)] + 0.5 * rng.standard_normal((n, d))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def walk_to_z(out, m: int, n: int):
    from vbx_tpu_torch.clustering.device import _finalize

    ma, mb, md = (t[m, :n - 1].cpu().numpy() for t in out[:3])
    return _finalize(ma, mb, md, n)


def cut_labels_equal(Z, Zref, thr: float, bias: float) -> bool:
    """Labels of Z and Zref equal at the AHC cut -(thr + bias) and at two
    cuts in the middle of Zref's merge gaps (tests/test_clustering.py)."""
    import numpy as np

    from vbx_tpu_torch.clustering import fcluster_by_distance

    n = len(Zref) + 1
    adjust = abs(Zref[:, 2].min())
    ds = np.sort(Zref[:, 2])
    cuts = [-(thr + bias) + adjust]
    for q in (0.3, 0.7):
        i = int(q * (n - 1))
        cuts.append(0.5 * (ds[i] + ds[i + 1]) + adjust)
    for cut in cuts:
        la, lb = (fcluster_by_distance(
            np.c_[z[:, :2], z[:, 2] + adjust, z[:, 3]], cut)
            for z in (Z, Zref))
        if not np.array_equal(la, lb):
            return False
    return True


def walk_bound_ms(steps: int, rows: int, n: int, d: int = AHC_D) -> float:
    """The bytes this walk read, over the card's HBM rate: each step the
    sum rows and sizes of its live clusters (`rows` sums their count over
    the steps, as the kernel counted it) and the lane's n active flags.
    The sums stay in L2 through the walk, so the HBM rate overstates the
    time these bytes need (csrc/nn_chain.cu)."""
    return (rows * (d + 1) * 8 + steps * n * 4) / HBM_BYTES_PER_S * 1e3


def device_ahc_path(work: str) -> dict:
    """Phase 8: the NN-chain walk kernel, the calibration sweeps, the
    'auto' route and the corpus pre-stage (module docstring)."""
    import numpy as np
    import torch

    from vbx_tpu_torch.clustering import (linkage_dot_avg,
                                          set_native_threads)
    from vbx_tpu_torch.clustering import device as cdev
    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.device import full_fp32_matmuls
    from vbx_tpu_torch.engine import ahc
    from vbx_tpu_torch.engine import pipeline
    from vbx_tpu_torch.ops import calibration
    from vbx_tpu_torch.testing import write_corpus

    t_phase = time.perf_counter()
    bias = get_preset("example").ahc.threshold
    cores = os.cpu_count() or 1
    out = {"walk": {}, "sweep": {}}

    def walk(sums, ns, **kw):
        r = cdev.nn_chain_walk(sums, ns, **kw)
        torch.cuda.synchronize()
        return r

    def timed(fn, n=3):
        fn()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    for n in AHC_NS:
        xn = ahc_xn(n, n)
        sums = torch.from_numpy(xn)[None].cuda()
        ms = timed(lambda: walk(sums, [n]))
        res = walk(sums, [n])
        if bool(res[3][0]):
            fail(f"walk at N={n}: the reducibility guard tripped")
        steps, rows = int(res[4][0]), int(res[5][0])
        Zd = walk_to_z(res, 0, n)
        set_native_threads(cores)
        t0 = time.perf_counter()
        Zh = linkage_dot_avg(xn, backend="native")
        host_s = time.perf_counter() - t0
        host1_s = None
        if n in AHC_ONE_THREAD_NS:
            set_native_threads(1)
            t0 = time.perf_counter()
            linkage_dot_avg(xn, backend="native")
            host1_s = time.perf_counter() - t0
            set_native_threads(cores)
        dd = float(np.abs(np.sort(Zh[:, 2]) - np.sort(Zd[:, 2])).max())
        t0 = time.perf_counter()
        _, thr_h = ahc._blocked_cosine_condensed_and_thr(
            xn, want_condensed=False)
        host_thr_s = time.perf_counter() - t0
        if not dd < AHC_PAIRS_BAR or Zd[-1, 3] != n:
            fail(f"walk at N={n}: sorted distances off by {dd}")
        if not cut_labels_equal(Zd, Zh, thr_h, bias):
            fail(f"walk at N={n}: labels differ from the host chain's")
        # the calibration sweep: threshold against the host's, one pass
        calibration.two_gmm_calib_cosine_device(xn, device="cuda")
        t0 = time.perf_counter()
        thr_d = calibration.two_gmm_calib_cosine_device(xn, device="cuda")
        dev_thr_s = time.perf_counter() - t0
        if not abs(thr_d - thr_h) < AHC_THR_BAR:
            fail(f"sweep at N={n}: threshold {thr_d} vs host {thr_h}")
        n_pad = calibration._padded_rows(n, 512)
        xp = torch.zeros((1, n_pad, AHC_D), device="cuda")
        xp[0, :n] = sums[0].float()
        nsd = torch.tensor([n], device="cuda")
        dc = torch.tensor([3.0], device="cuda")
        with full_fp32_matmuls():
            pass_ms = _cuda_ms(lambda: calibration._cosine_sweep(
                xp, nsd, dc, -dc, 512), n=5)
            mm_ms = _cuda_ms(lambda: torch.bmm(
                xp[:, :4096], xp.transpose(1, 2)), n=5) * n_pad / 4096
        out["walk"][n] = {
            "ms": ms, "steps": steps, "us_per_step": ms * 1e3 / steps,
            "cycles_per_step": ms * 1e-3 * SM_CLOCK_HZ / steps,
            "rows": rows, "bound_ms": walk_bound_ms(steps, rows, n),
            "grid": cdev.nn_chain_walk.grid,
            "host_s": host_s, "host_1thread_s": host1_s, "dist_err": dd}
        out["sweep"][n] = {
            "thr_err": abs(thr_d - thr_h), "n_pad": n_pad,
            "device_s": dev_thr_s, "host_s": host_thr_s,
            "pass_ms": pass_ms, "matmul_ms": mm_ms,
            "bound_ms": 2 * n * n * AHC_D / F32_OPS_PER_S * 1e3}

    # the per-step floor: a walk this short is barriers and bookkeeping
    xf = torch.from_numpy(ahc_xn(AHC_FLOOR_N, 1))[None].cuda()
    f_ms = timed(lambda: walk(xf, [AHC_FLOOR_N]), n=5)
    f_steps = int(walk(xf, [AHC_FLOOR_N])[4][0])
    out["floor"] = {"n": AHC_FLOOR_N, "steps": f_steps,
                    "us_per_step": f_ms * 1e3 / f_steps}

    # the kernel against its plain twin (the JSON line's numbers)
    n = AHC_TWIN_N
    xn = ahc_xn(n, 5)
    sums = torch.from_numpy(xn)[None].cuda()
    k_res = walk(sums, [n])
    t0 = time.perf_counter()
    p_res = cdev.nn_chain_walk_plain(sums, [n])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ms = timed(lambda: walk(sums, [n]), n=5)
    Zk, Zp = walk_to_z(k_res, 0, n), walk_to_z(p_res, 0, n)
    err = float(np.abs(np.sort(Zk[:, 2]) - np.sort(Zp[:, 2])).max())
    _, thr_h = ahc._blocked_cosine_condensed_and_thr(xn, want_condensed=False)
    if bool(p_res[3][0]) or not err < AHC_PAIRS_BAR \
            or not cut_labels_equal(Zk, Zp, thr_h, bias):
        fail(f"walk kernel vs its plain twin at N={n}: distances {err}")
    steps, rows = int(k_res[4][0]), int(k_res[5][0])
    same = bool(torch.equal(k_res[0], p_res[0])
                and torch.equal(k_res[1], p_res[1]))
    if same and (steps != int(p_res[4][0]) or rows != int(p_res[5][0])):
        fail(f"walk kernel vs its plain twin at N={n}: the same merges in "
             f"other steps or scans")
    out["twin"] = {"n": n, "ms": ms, "plain_ms": plain_ms,
                   "max_abs_err": err, "steps": steps, "rows": rows,
                   "twin_steps": int(p_res[4][0]),
                   "bound_ms": walk_bound_ms(steps, rows, n),
                   "same_pairs": float(np.mean(
                       np.all(Zk[:, :2] == Zp[:, :2], axis=1)))}

    # the crossover: the walk against the host chain on one thread
    out["cross"] = {}
    for n in AHC_CROSS_NS:
        xn = ahc_xn(n, 7 * n)
        sums = torch.from_numpy(xn)[None].cuda()
        ms = timed(lambda: walk(sums, [n]))
        Zd = walk_to_z(walk(sums, [n]), 0, n)
        set_native_threads(1)
        t0 = time.perf_counter()
        Zh = linkage_dot_avg(xn, backend="native")
        host1_ms = (time.perf_counter() - t0) * 1e3
        set_native_threads(cores)
        dd = float(np.abs(np.sort(Zh[:, 2]) - np.sort(Zd[:, 2])).max())
        _, thr_h = ahc._blocked_cosine_condensed_and_thr(
            xn, want_condensed=False)
        if not dd < AHC_PAIRS_BAR or not cut_labels_equal(Zd, Zh, thr_h,
                                                          bias):
            fail(f"walk at N={n}: distances {dd} or labels off the host's")
        out["cross"][n] = {"ms": ms, "host_1thread_ms": host1_ms,
                           "dist_err": dd}

    # batch invariance: four lanes in one launch, bit-equal alone, and at
    # one and two blocks an SM; the batched call's time
    ns = list(AHC_BATCH_NS)
    xs = [ahc_xn(n, 100 + n) for n in ns]
    big = np.zeros((len(ns), max(ns), AHC_D))
    for m, x in enumerate(xs):
        big[m, :len(x)] = x
    big = torch.from_numpy(big).cuda()
    batched_ms = timed(lambda: walk(big, ns))
    full = walk(big, ns)
    grids = [walk(big, ns, blocks_per_sm=b) for b in (1, 2)]
    for m, n in enumerate(ns):
        alone = walk(big[m:m + 1, :n].contiguous(), [n])
        for j in range(6):
            if j > 2:      # bad, steps, rows: one number a lane
                if not int(full[j][m]) == int(alone[j][0]) \
                        == int(grids[0][j][m]) == int(grids[1][j][m]):
                    fail(f"walk lane N={n}: output {j} differs alone / "
                         f"batched / at 1 or 2 blocks an SM")
                continue
            for other in (alone[j][0], grids[0][j][m], grids[1][j][m]):
                if not torch.equal(full[j][m, :n - 1], other[:n - 1]):
                    fail(f"walk lane N={n}: not bit-equal alone / batched / "
                         f"at 1 or 2 blocks an SM")
    out["batched"] = {"ns": ns, "ms": batched_ms,
                      "steps": [int(v) for v in full[4].cpu()],
                      "bound_ms": sum(
                          walk_bound_ms(int(st), int(r), n) for st, r, n
                          in zip(full[4].cpu(), full[5].cpu(), ns))}
    thr_b = calibration.two_gmm_calib_cosine_device_batched(xs,
                                                            device="cuda")
    errs = []
    for m, x in enumerate(xs):
        _, th = ahc._blocked_cosine_condensed_and_thr(x,
                                                      want_condensed=False)
        errs.append(abs(thr_b[m] - th))
        if not errs[-1] < AHC_THR_BAR:
            fail(f"batched sweep lane N={ns[m]}: {thr_b[m]} vs host {th}")
    out["batched"]["thr_err"] = max(errs)

    # the 'auto' route at N=10000 launches the walk once, no fallback
    xn = ahc_xn(10000, 10000)
    before = cdev.nn_chain_walk.launches
    ahc._try_device_linkage.fallbacks = 0
    import warnings as _w
    with _w.catch_warnings(record=True) as caught:
        _w.simplefilter("always")
        lab_auto = ahc.ahc_labels(xn, bias, compute_backend="auto",
                                  device="cuda")
    if ahc._try_device_linkage.fallbacks or any(
            "falling back" in str(c.message) for c in caught):
        fail("ahc_labels('auto', cuda) at N=10000 fell back to the host")
    if cdev.nn_chain_walk.launches != before + 1:
        fail("ahc_labels('auto', cuda) at N=10000 did not launch the walk "
             "once")
    lab_host = ahc.ahc_labels(xn, bias, compute_backend="host")
    if not np.array_equal(lab_auto, lab_host):
        fail("ahc_labels('auto', cuda) at N=10000: labels differ from "
             "'host'")
    out["auto_clusters"] = int(lab_auto.max()) + 1

    # the corpus pre-stage: 4 AMI-length recordings through diarize_ark
    t0 = time.perf_counter()
    corpus = write_corpus(os.path.join(work, "pre"), 21, PRE_LENGTHS,
                          (4, 5, 6, 8))
    write_s = time.perf_counter() - t0
    seen = {}
    real = pipeline.Diarizer.initial_labels

    def spy(tag):
        def initial_labels(self, x, seed=0, **kw):
            lab = real(self, x, seed=seed, **kw)
            seen[(tag, len(x))] = lab
            return lab
        return initial_labels

    runs = {}
    host_cfg = get_preset("example")
    host_cfg = host_cfg.replace(ahc=dataclasses.replace(
        host_cfg.ahc, compute_backend="host"))
    for tag, cfg in (("auto", get_preset("example")), ("host", host_cfg)):
        pipeline.Diarizer.initial_labels = spy(tag)
        cdev.nn_chain_walk.launches = 0
        runlog = os.path.join(work, f"pre_{tag}.jsonl")
        t0 = time.perf_counter()
        try:
            pipeline.diarize_ark(
                corpus["ark"], corpus["segments"],
                os.path.join(work, f"pre_{tag}"), cfg, corpus["plda"],
                corpus["transform"], verbose=False, fb_impl="pallas",
                device="cuda", runlog_path=runlog)
        finally:
            pipeline.Diarizer.initial_labels = real
        stages = [json.loads(line) for line in open(runlog)
                  if '"stages"' in line][-1]
        runs[tag] = {"s": time.perf_counter() - t0,
                     "walk_launches": cdev.nn_chain_walk.launches,
                     "stages": stages}
    st = runs["auto"]["stages"]
    if st.get("pre_linkage_recordings") != len(PRE_LENGTHS):
        fail(f"pre-stage linked {st.get('pre_linkage_recordings')} of "
             f"{len(PRE_LENGTHS)} recordings")
    if runs["host"]["walk_launches"] or not runs["auto"]["walk_launches"]:
        fail(f"pre-stage walk launches: {runs}")
    for n in PRE_LENGTHS:
        if not np.array_equal(seen[("auto", n)], seen[("host", n)]):
            fail(f"pre-stage initial labels at N={n} differ from 'host'")
    for f in sorted(os.listdir(os.path.join(work, "pre_host"))):
        a, b = (open(os.path.join(work, d, f)).read()
                for d in ("pre_auto", "pre_host"))
        if a != b:
            fail(f"pre-stage RTTM {f} differs from the 'host' run's")
    out["pre"] = {"write_s": write_s, "auto_s": runs["auto"]["s"],
                  "host_s": runs["host"]["s"],
                  "walk_launches": runs["auto"]["walk_launches"],
                  "pre_linkage_s": st["pre_linkage_s"],
                  "pre_linkage_recordings": st["pre_linkage_recordings"],
                  "init_s": {k: r["stages"]["init_s"]
                             for k, r in runs.items()}}
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(base: str, path: str, payload=None):
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"{base}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def write_seeded_resnet101(path: str) -> str:
    """Phase 7's seeded ResNet101 (seed 0, embedding bias zero) saved as a
    state-dict checkpoint at `path`; returns the path."""
    import torch

    from vbx_tpu_torch.models.resnet import resnet101

    torch.manual_seed(0)
    model = resnet101(64, 256)
    torch.nn.init.zeros_(model.embedding.bias)
    torch.save(model.state_dict(), path)
    return path


def serving_path(work: str) -> dict:
    """Phase 9: DiarizationService on the card over the smoke corpus from
    SERVE_THREADS threads, one AMI-length request, and the HTTP daemon."""
    import signal
    import threading
    import warnings as _w

    import numpy as np
    import torch

    from vbx_tpu_torch.clustering import device as cdev
    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.engine import ahc
    from vbx_tpu_torch.io.ark import read_vec_ark_grouped, write_vec_ark
    from vbx_tpu_torch.io.segments import (read_xvector_timing_dict,
                                           write_segments)
    from vbx_tpu_torch.ops import fb_kernel
    from vbx_tpu_torch.serving import DiarizationService
    from vbx_tpu_torch.testing import (main_path_corpus, synth_recording,
                                       write_audio_corpus)

    t_phase = time.perf_counter()
    corpus = main_path_corpus(os.path.join(work, "corpus"))
    cfg = get_preset("callhome")      # a corpus preset: 'pallas_bf16'
    ref = diarize(corpus, os.path.join(work, "offline"), cfg, "cuda",
                  "pallas")
    segs = read_xvector_timing_dict(corpus["segments"])
    recs = [(rec, x, segs[rec][1]) for rec, _, x in
            read_vec_ark_grouped(corpus["ark"])]
    with _w.catch_warnings(record=True) as caught:
        _w.simplefilter("always")
        svc = DiarizationService.from_files(cfg, corpus["plda"],
                                            corpus["transform"],
                                            device="cuda")
    if svc._fb_impl != "pallas" or not any(
            "overriding the config's" in str(c.message) for c in caught):
        fail(f"the service's engine is {svc._fb_impl!r}, not the serving "
             f"default 'pallas' over the preset's 'pallas_bf16'")
    out = {}
    try:
        svc.warmup(batch_sizes=(1, 8), payload=recs[0][1:])
        fb_kernel.fb_fused_sb.launches = 0
        cdev.nn_chain_walk.launches = 0
        results, errors = {}, []
        lock = threading.Lock()

        def client(items):
            try:
                futs = [(rec, svc.submit(rec, x, ts)) for rec, x, ts in items]
                for rec, f in futs:
                    r = f.result(timeout=600)
                    with lock:
                        results[rec] = r
            except Exception as exc:   # noqa: BLE001 — reported below
                errors.append(exc)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client,
                                    args=(recs[k::SERVE_THREADS],))
                   for k in range(SERVE_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors or len(results) != len(recs):
            fail(f"service: {len(results)} results, errors {errors[:2]}")
        k1 = fb_kernel.fb_fused_sb.launches
        if k1 < 1:
            fail("service: K1 was not launched")
        diff = [rec for rec in results if not np.array_equal(
            results[rec].labels1st, ref[rec].labels1st)]
        if diff:
            fail(f"service labels differ from diarize_ark's on {diff[:4]}")
        lat = np.array([r.wall_ms for r in results.values()])
        stats = svc.stats()
        out["service"] = {
            "requests": len(results), "threads": SERVE_THREADS,
            "wall_s": wall, "req_per_s": len(results) / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "batches": stats["batches"], "max_batch": stats["max_batch"],
            "k1_launches": k1, "walk_launches": cdev.nn_chain_walk.launches}

        # one AMI-length request: one walk launch, the host route's labels
        x_ami, _ = synth_recording(np.random.default_rng(35), AMI_N, 6)
        ts_ami = np.stack([np.arange(AMI_N) * 0.24,
                           np.arange(AMI_N) * 0.24 + 1.44], axis=1)
        cdev.nn_chain_walk.launches = 0
        ahc._try_device_linkage.fallbacks = 0
        t0 = time.perf_counter()
        r_ami = svc.diarize("ami", x_ami, ts_ami, timeout=600)
        ami_s = time.perf_counter() - t0
        if cdev.nn_chain_walk.launches != 1:
            fail(f"AMI-length request: {cdev.nn_chain_walk.launches} walk "
                 f"launches")
        if ahc._try_device_linkage.fallbacks:
            fail("AMI-length request: the walk's guard tripped and the "
                 "host chain answered")
        host_cfg = cfg.replace(ahc=dataclasses.replace(
            cfg.ahc, compute_backend="host"))
        with DiarizationService(host_cfg, *corpus["models"], device="cuda",
                                fb_impl="pallas") as s_host:
            want = s_host.diarize("ami", x_ami, ts_ami,
                                  timeout=600).labels1st
        if not np.array_equal(r_ami.labels1st, want):
            fail("AMI-length request: labels differ from the host route's")
        out["ami"] = {"n": AMI_N, "s": ami_s, "speakers": r_ami.n_speakers,
                      "iters": r_ami.n_iters}
    finally:
        svc.close()

    # the HTTP daemon: a subprocess on a free local port
    ckpt = write_seeded_resnet101(os.path.join(work, "resnet101.pth"))
    names, wavs, labs = write_audio_corpus(os.path.join(work, "audio"), 17,
                                           (60.0,), EXTRACT_FS)
    rec0, x0, ts0 = recs[0]
    one_ark = os.path.join(work, "one.ark")
    one_seg = os.path.join(work, "one.seg")
    write_vec_ark(one_ark, [(f"{rec0}_{i:05d}", v) for i, v in
                            enumerate(x0)])
    write_segments(one_seg, [(f"{rec0}_{i:05d}", rec0, float(s), float(e))
                             for i, (s, e) in enumerate(ts0)])
    port = _free_port()
    log = open(os.path.join(work, "serve.log"), "w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "vbx_tpu_torch.cli.serve", "--preset",
         "callhome", "--plda-file", corpus["plda"], "--xvec-transform",
         corpus["transform"], "--weights", ckpt, "--port", str(port),
         "--device", "cuda", "--max-pending-requests", "1"],
        cwd=HERE, stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(600):
            try:
                code, health = _http(base, "/healthz")
                break
            except OSError:
                if proc.poll() is not None:
                    log.seek(0)
                    fail(f"daemon exited: {log.read()[-2000:]}")
                time.sleep(0.25)
        else:
            fail("the daemon never answered /healthz")
        up_s = time.perf_counter() - t0
        kind = torch.cuda.get_device_name(0)
        if health.get("backend") != "cuda" or health.get("device") != kind \
                or health.get("audio") is not True:
            fail(f"/healthz: {health}")
        code, r_in = _http(base, "/diarize", {
            "recording": rec0, "xvectors": x0.tolist(),
            "timestamps": ts0.tolist()})
        with open(os.path.join(work, "offline", f"{rec0}.rttm")) as fp:
            want_rttm = fp.read()
        if code != 200 or r_in["rttm"] != want_rttm:
            fail(f"inline request: {code} {str(r_in)[:300]}")
        code, r_ark = _http(base, "/diarize", {"xvec_ark_file": one_ark,
                                               "segments_file": one_seg})
        if code != 200 or r_ark["results"][rec0]["rttm"] != want_rttm:
            fail(f"ark request: {code} {str(r_ark)[:300]}")
        code, r_wav = _http(base, "/diarize", {"wav_file": wavs[0],
                                               "lab_file": labs[0]})
        if code != 200 or not r_wav["rttm"].startswith(
                f"SPEAKER {names[0]} 1 "):
            fail(f"wav request: {code} {str(r_wav)[:300]}")
        # the whole corpus's ark at an admission bound of 1: the second
        # recording is refused
        code, r_503 = _http(base, "/diarize", {
            "xvec_ark_file": corpus["ark"],
            "segments_file": corpus["segments"]})
        if code != 503 or "max_pending_requests" not in r_503["error"]:
            fail(f"overload: {code} {str(r_503)[:300]}")
        code, stats = _http(base, "/stats")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        log.seek(0)
        text = log.read()
        if rc != 0 or "drained and stopped" not in text:
            fail(f"daemon SIGTERM: rc {rc}, {text[-1500:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    out["http"] = {"up_s": up_s, "healthz": health,
                   "wav_speakers": r_wav["n_speakers"],
                   "inline_ms": r_in["wall_ms"], "wav_ms": r_wav["wall_ms"],
                   "stats_requests": stats["requests"]}
    out["seconds"] = time.perf_counter() - t_phase
    return out


# multi-host corpus runs (phase 10): one corpus-runner stage in processes
# started together, each `python -m vbx_tpu_torch.cli.run_corpus`'s main()
# followed by the process's K1 launch count
CORPUS_CHILD = """
import json, sys
from vbx_tpu_torch.cli import run_corpus
from vbx_tpu_torch.ops import fb_kernel
rc = run_corpus.main(sys.argv[1:])
print("k1_launches " + json.dumps(fb_kernel.fb_fused_sb.launches))
sys.exit(rc)
"""
STARTUP_CHILD = ("import torch, vbx_tpu_torch.cli.run_corpus; "
                 "torch.zeros(1, device='cuda'); torch.cuda.synchronize()")
CLUSTER_ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


def corpus_stage(argv, n_proc: int, log_dir: str) -> dict:
    """The corpus runner's stage `argv` in n_proc processes started
    together (with n_proc > 1, one gloo group: COORDINATOR_ADDRESS on a
    free local port, NUM_PROCESSES, PROCESS_ID): the wall seconds from the
    first spawn to the last exit (process start-up and CUDA initialization
    included), the K1 launches summed over the processes, and each
    process's output. A process that exits non-zero, or that is still
    running after STAGE_TIMEOUT, fails the phase; every process is ended
    before this returns."""
    env = {k: v for k, v in os.environ.items() if k not in CLUSTER_ENV}
    env["PYTHONPATH"] = HERE
    port = _free_port()
    envs = [env] if n_proc == 1 else [
        {**env, "COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
         "NUM_PROCESSES": str(n_proc), "PROCESS_ID": str(p)}
        for p in range(n_proc)]
    logs = [open(os.path.join(log_dir, f"{argv[0]}_{n_proc}_{p}.log"), "w+")
            for p in range(n_proc)]
    procs = []
    timed_out = False
    try:
        t0 = time.perf_counter()
        for e, log in zip(envs, logs):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CORPUS_CHILD, *argv], cwd=HERE,
                env=e, stdout=log, stderr=subprocess.STDOUT))
        try:
            for p in procs:
                p.wait(timeout=max(1.0, t0 + STAGE_TIMEOUT
                                   - time.perf_counter()))
        except subprocess.TimeoutExpired:
            timed_out = True
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
    for i, (p, text) in enumerate(zip(procs, texts)):
        if timed_out or p.returncode != 0:
            fail(f"{argv[0]} stage, process {i} of {n_proc}: exit "
                 f"{p.returncode}"
                 + (f" (ended after {STAGE_TIMEOUT} s)" if timed_out else "")
                 + f": {text[-3000:]}")
    k1 = sum(int(line.split()[1]) for text in texts
             for line in text.splitlines() if line.startswith("k1_launches "))
    return {"wall_s": wall, "k1_launches": k1, "outputs": texts}


def startup_s() -> float:
    """Seconds from spawn to exit of a process that imports the port and
    initializes CUDA on cuda:0 (what every stage process pays first)."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", STARTUP_CHILD], cwd=HERE,
                         env={**os.environ, "PYTHONPATH": HERE},
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"start-up probe: {res.stderr[-2000:]}")
    return time.perf_counter() - t0


def _exp_dir(work: str, name: str, corpus) -> str:
    """An experiment directory whose x-vector stage output is the corpus's
    ark and segments (linked)."""
    exp = os.path.join(work, name)
    os.makedirs(exp)
    os.symlink(corpus["ark"], os.path.join(exp, "xvectors.ark"))
    os.symlink(corpus["segments"], os.path.join(exp, "xvectors.seg"))
    return exp


def multi_host_path(work: str) -> dict:
    """Phase 10 (a) and (b): the corpus runner's stages in one process and
    in two processes of one gloo group on cuda:0 (module docstring)."""
    import numpy as np

    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.io.ark import iter_vec_ark
    from vbx_tpu_torch.testing import (main_path_corpus, write_audio_corpus,
                                       write_truth_rttms)

    t_phase = time.perf_counter()
    out = {"startup_s": startup_s()}

    # (a) diarization and score stages on phase 4's corpus, callhome
    corpus = main_path_corpus(os.path.join(work, "corpus"))
    refs = os.path.join(work, "refs")
    write_truth_rttms(refs, corpus["truth"])
    names = sorted(corpus["truth"])
    lst = os.path.join(work, "list.txt")
    with open(lst, "w") as f:
        f.writelines(f"{n}\n" for n in names)
    protocols = get_preset("callhome").protocols
    runs = {}
    for n_proc in (1, 2):
        exp = _exp_dir(work, f"exp{n_proc}", corpus)
        common = ["--preset", "callhome", "--list-file", lst,
                  "--exp-dir", exp]
        d = corpus_stage(["diarization", *common, "--plda-file",
                          corpus["plda"], "--xvec-transform",
                          corpus["transform"]], n_proc, work)
        written = os.listdir(os.path.join(exp, "rttms"))
        if len(written) != N_RECORDINGS or d["k1_launches"] < 1:
            fail(f"diarization stage in {n_proc} process(es): "
                 f"{len(written)} RTTMs, {d['k1_launches']} K1 launches")
        sc = corpus_stage(["score", *common, "--ref-rttm-dir", refs], 1,
                          work)
        lines = [ln for ln in sc["outputs"][0].splitlines()
                 if ln.split(":")[0] in protocols]
        if len(lines) != len(protocols):
            fail(f"score stage after {n_proc} process(es): "
                 f"{sc['outputs'][0][-1000:]}")
        with open(os.path.join(exp, "all.rttm"), "rb") as f:
            body = f.read()
        runs[n_proc] = {"diarization_s": d["wall_s"],
                        "k1_launches": d["k1_launches"],
                        "score_s": sc["wall_s"], "score": lines,
                        "all": body, "exp": exp}
    if runs[1]["all"] != runs[2]["all"]:
        diff = []
        for n in names:
            a, b = (open(os.path.join(runs[k]["exp"], "rttms", f"{n}.rttm"),
                         "rb").read() for k in (1, 2))
            if a != b:
                diff.append(n)
        fail(f"diarization stage: all.rttm of 2 processes differs from 1 "
             f"process on {len(diff)} recording(s): {diff[:8]}")
    if runs[1]["score"] != runs[2]["score"]:
        fail(f"score stage lines differ: {runs[1]['score']} vs "
             f"{runs[2]['score']}")
    for r in runs.values():
        del r["all"], r["exp"]
    out["a"] = runs

    # (b) the xvectors stage on phase 7's audio with the seeded ResNet101
    audio = os.path.join(work, "audio")
    anames, _, _ = write_audio_corpus(audio, 13, EXTRACT_SECONDS, EXTRACT_FS)
    ckpt = write_seeded_resnet101(os.path.join(work, "resnet101.pth"))
    alst = os.path.join(work, "audio.txt")
    with open(alst, "w") as f:
        f.writelines(f"{n}\n" for n in anames)
    xv = {}
    for n_proc in (1, 2):
        exp = os.path.join(work, f"xv{n_proc}")
        r = corpus_stage(["xvectors", "--preset", "ami_mixheadset",
                          "--list-file", alst, "--exp-dir", exp,
                          "--wav-dir", audio, "--lab-dir", audio,
                          "--weights", ckpt], n_proc, work)
        with open(os.path.join(exp, "xvectors.seg"), "rb") as f:
            seg = f.read()
        with open(os.path.join(exp, "xvectors.ark"), "rb") as f:
            ark = f.read()
        xv[n_proc] = {"s": r["wall_s"], "seg": seg, "ark": ark,
                      "vecs": list(iter_vec_ark(os.path.join(
                          exp, "xvectors.ark")))}
    one, two = xv[1], xv[2]
    keys = [k for k, _ in one["vecs"]]
    if keys != [k for k, _ in two["vecs"]] or one["seg"] != two["seg"]:
        fail("xvectors stage: keys or segments of 2 processes differ from "
             "1 process")
    if {k.split("_")[0] for k in keys} != set(anames):
        fail("xvectors stage: a recording is missing from the ark")
    res = {"s_1": one["s"], "s_2": two["s"], "windows": len(keys),
           "byte_equal": one["ark"] == two["ark"]}
    if not res["byte_equal"]:
        a = np.stack([v for _, v in one["vecs"]])
        b = np.stack([v for _, v in two["vecs"]])
        cos = float(_cos(b, a).min())
        err = float(np.abs(b - a).max() / np.abs(a).max())
        if not (cos >= XV_SPLIT_COS and err <= XV_SPLIT_ERR):
            fail(f"xvectors stage: 2 processes vs 1: cosine {cos}, max abs "
                 f"error / max {err}")
        res.update(cos_min=cos, err=err)
    out["b"] = res
    out["seconds"] = time.perf_counter() - t_phase
    return out


def multi_card_path(work: str) -> dict:
    """Phase 10 (c) and (d): dryrun_multichip over every visible card (over
    cuda:0 four times with one card), and with at least two cards the mesh
    EM at phase 5's shape over distinct cards beside cuda:0 repeated."""
    import torch

    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.ops import fb_kernel, fb_product_kernel
    from vbx_tpu_torch.parallel import make_mesh
    from vbx_tpu_torch.parallel.dryrun import dryrun_multichip
    from vbx_tpu_torch.testing import write_corpus

    n_cards = torch.cuda.device_count()
    fb_kernel.fb_fused_sb.launches = 0
    fb_product_kernel.fb_fwd_product_sb.launches = 0
    t0 = time.perf_counter()
    if n_cards >= 2:
        dry = dryrun_multichip(n_cards)
    else:
        dry = dryrun_multichip(4, devices=["cuda:0"] * 4)
    _sync_all()
    dry.update(seconds=time.perf_counter() - t0,
               k1_launches=fb_kernel.fb_fused_sb.launches,
               k2_launches=fb_product_kernel.fb_fwd_product_sb.launches)
    if dry["k1_launches"] < 1 or dry["k2_launches"] < 1:
        fail(f"dryrun_multichip: K1 launched {dry['k1_launches']} times, "
             f"K2 {dry['k2_launches']} times")
    out = {"cards": n_cards, "c": dry}
    if n_cards < 2:
        out["d"] = None
        return out
    n_sp = 4 if n_cards >= 4 else 2
    corpus = write_corpus(os.path.join(work, "long"), 11, MESH_LENGTHS,
                          [MESH_SPEAKERS] * len(MESH_LENGTHS))
    cfg = get_preset("example").replace(init=f"random_{MESH_SPEAKERS}+VB")
    cards = [torch.device("cuda", i) for i in range(n_sp)]
    d = mesh_em_ms(corpus, cfg, {
        "distinct": make_mesh(1, n_sp, devices=cards),
        "repeated": make_mesh(1, n_sp, devices=[cards[0]] * n_sp)})
    # the same shards and kernels on other cards: the same bits
    g = d.pop("gamma")
    if not torch.equal(g["distinct"], g["repeated"]):
        fail(f"mesh EM over distinct cards differs from cuda:0 repeated by "
             f"{float((g['distinct'] - g['repeated']).abs().max())}")
    out["d"] = d
    return out


def print_multi_host(mh: dict) -> None:
    st = mh["startup_s"]
    a = mh["a"]
    for n_proc in (1, 2):
        r = a[n_proc]
        print(f"multi-host (a) diarization stage, callhome (K1 bfloat16), "
              f"{N_RECORDINGS} recordings, {n_proc} process(es) on cuda:0: "
              f"{r['diarization_s']:.2f} s, K1 launches {r['k1_launches']}; "
              f"score stage (one process, host) {r['score_s']:.2f} s")
    print(f"multi-host (a): the stage times are wall seconds from spawn to "
          f"the last exit, each process's start-up and CUDA initialization "
          f"included ({st:.2f} s for a process that imports the port and "
          f"initializes cuda:0); all.rttm of 2 processes byte-equal to 1 "
          f"process; score lines equal: {' | '.join(a[1]['score'])}")
    b = mh["b"]
    how = ("x-vectors byte-equal" if b["byte_equal"] else
           f"x-vectors not byte-equal: cosine >= {b['cos_min']:.8f}, max "
           f"abs error / max {b['err']:.3g} (bar {XV_SPLIT_COS}, "
           f"{XV_SPLIT_ERR})")
    print(f"multi-host (b) xvectors stage, ami_mixheadset, "
          f"{len(EXTRACT_SECONDS)} x {EXTRACT_SECONDS[0]:.0f} s at "
          f"{EXTRACT_FS} Hz, seeded ResNet101 ({b['windows']} windows): 1 "
          f"process {b['s_1']:.2f} s, 2 processes {b['s_2']:.2f} s (start-up "
          f"and CUDA initialization included); keys and segments "
          f"byte-equal; {how}; phase {mh['seconds']:.1f} s")


def print_multi_card(mc: dict) -> None:
    c = mc["c"]
    where = ("every visible card" if mc["cards"] >= 2 else
             f"cuda:0 repeated 4 times ({mc['cards']} card visible)")
    print(f"multi-card (c) dryrun_multichip over {where}: mesh {c['mesh']} "
          f"on {c['devices']}: {', '.join(c['checks'])} held; K1 launches "
          f"{c['k1_launches']}, K2 launches {c['k2_launches']}; "
          f"{c['seconds']:.2f} s")
    d = mc["d"]
    if d is None:
        print(f"multi-card (d) not run: {mc['cards']} card visible, and the "
              f"mesh EM over distinct cards needs at least 2 (a missing "
              f"device, not a caught failure)")
    else:
        ms = d["ms_per_iter"]
        print(f"multi-card (d) EM at B,T,S,D={d['shape']} (pallas, "
              f"{d['iters']} iterations): mesh {d['meshes']['distinct']} over "
              f"{d['devices']['distinct']} {ms['distinct']} ms/iter; the "
              f"same mesh over cuda:0 repeated {ms['repeated']} ms/iter, "
              f"gamma bit-equal; solo {ms['solo']} ms/iter")


def bench_phase() -> dict:
    """Phase 11: `python3 bench_torch.py` in a process of its own, ended
    if it runs past BENCH_TIMEOUT (module docstring)."""
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable,
                              os.path.join(HERE, "bench_torch.py")],
                             cwd=HERE, capture_output=True, text=True,
                             timeout=BENCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"bench_torch.py ran past {BENCH_TIMEOUT} s")
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"bench_torch.py exited {res.returncode}: {res.stderr[-4000:]}")
    line = json.loads(res.stdout.strip().splitlines()[-1])
    want = [BENCH["B"], BENCH["T"], BENCH["S"], BENCH["D"]]
    if line["shape"] != want:
        fail(f"bench_torch.py ran shape {line['shape']}, not {want}")
    if line["headline_impl"] not in ("pallas", "pallas_bf16"):
        fail(f"bench_torch.py headline_impl {line['headline_impl']!r}")
    if not line["k1_launches"] > 0:
        fail(f"bench_torch.py launched K1 {line['k1_launches']} times")
    if not (line["value"] > 0 and line["vs_baseline"] > 0):
        fail(f"bench_torch.py value {line['value']}, vs_baseline "
             f"{line['vs_baseline']}")
    if not line["e2e_agreement"] >= BENCH_E2E_AGREEMENT:
        fail(f"bench_torch.py e2e agreement {line['e2e_agreement']}")
    if not line["guard"][line["headline_impl"]]["ok"]:
        fail(f"bench_torch.py headline failed its guard: {line['guard']}")
    return {"line": line, "seconds": secs,
            "log": " | ".join(res.stderr.strip().splitlines())}


def run_drivers(runs, card: str) -> dict:
    """Each (tag, argv, want) of `runs` as `python3 scripts/<script>` in a
    process of its own, ended if it runs past DRIVER_TIMEOUT: it must exit
    0, print a line matching `want` and end with a JSON line naming the
    card. Returns {tag: {"seconds", "lines" (stdout but the JSON line),
    "line" (the JSON line)}, "seconds": all of them}."""
    import re

    t_phase = time.perf_counter()
    out = {}
    for tag, argv, want in runs:
        cmd = [sys.executable, os.path.join(HERE, "scripts", argv[0]),
               *argv[1:]]
        t0 = time.perf_counter()
        try:
            res = subprocess.run(cmd, cwd=HERE, capture_output=True,
                                 text=True, timeout=DRIVER_TIMEOUT)
        except subprocess.TimeoutExpired:
            fail(f"driver {tag} ran past {DRIVER_TIMEOUT} s")
        secs = time.perf_counter() - t0
        if res.returncode != 0:
            fail(f"driver {tag} exited {res.returncode}: "
                 f"{res.stderr[-3000:]}")
        lines = res.stdout.strip().splitlines()
        if not any(re.search(want, ln) for ln in lines):
            fail(f"driver {tag} printed no line matching {want!r}: "
                 f"{res.stdout[-2000:]}")
        line = json.loads(lines[-1])
        if line["device"] != card:
            fail(f"driver {tag} measured on {line['device']!r}, not the "
                 f"card {card!r}")
        out[tag] = {"seconds": secs, "lines": lines[:-1], "line": line}
    out["seconds"] = time.perf_counter() - t_phase
    return out


def drivers_phase(card: str) -> dict:
    """Phase 12: every DRIVER_RUNS entry (run_drivers) and the gates the
    module docstring lists."""
    out = run_drivers(DRIVER_RUNS, card)
    check = out["ami_scale"]["line"]["check_vs_cpu"]
    if len(check) != 2 or min(check.values()) < AMI_CHECK_AGREEMENT:
        fail(f"AMI-scale labels vs the CPU structured run: {check}")
    rows = out["scaling"]["line"]["rows"]
    if not rows or min(r["agreement_vs_solo"] for r in rows) < \
            MESH_AGREE["pallas"]:
        fail(f"scaling: a mesh disagrees with the solo engine: {rows}")
    for tag in ("serving", "serving --ab"):
        if out[tag]["line"]["failures"]:
            fail(f"{tag}: {out[tag]['line']['failures']}")
    return out


def ab_launches(out: dict) -> dict:
    """The launches the kernel rows of phase 13's drivers counted, by
    driver and row (the JSON lines' counts, each reset just before its
    row's run and read just after); fails if a kernel row launched none:
    K1 in every kernel row, K2 in the sp kernel forms, the walk in the AHC
    driver's linkage."""
    got = {"ab_corpus_engine": {
               str(r["fb_impl"]): r["launches"]
               for r in out["ab_corpus_engine"]["line"]["rows"]},
           "ab_plateau": {
               rule: {"K1": out["ab_plateau"]["line"][rule]["k1_launches"]}
               for rule in ("off", "on")},
           "ab_ahc_device": {"linkage": {
               "walk": out["ab_ahc_device"]["line"]["linkage"]
               ["walk_launches"]}},
           "ab_sp_blockwise": {
               form: r["launches"] for form, r in
               out["ab_sp_blockwise"]["line"]["rows"].items()},
           "ab_s_gt_128": {
               f"S={r['S']} {r['fb_impl']}": {"K1": r["k1_launches"]}
               for r in out["ab_s_gt_128"]["line"]["rows"]}}
    need = (("ab_corpus_engine", "None", "K1"),
            ("ab_corpus_engine", "pallas", "K1"),
            ("ab_corpus_engine", "pallas_bf16", "K1"),
            ("ab_plateau", "off", "K1"), ("ab_plateau", "on", "K1"),
            ("ab_ahc_device", "linkage", "walk"),
            ("ab_sp_blockwise", "solo_pallas_bf16", "K1"),
            ("ab_sp_blockwise", "solo_pallas", "K1"),
            ("ab_sp_blockwise", "sp_pallas_bf16", "K1"),
            ("ab_sp_blockwise", "sp_pallas_bf16", "K2"),
            ("ab_sp_blockwise", "sp_pallas", "K1"),
            ("ab_sp_blockwise", "sp_pallas", "K2"),
            ("ab_s_gt_128", "S=128 pallas_bf16", "K1"),
            ("ab_s_gt_128", "S=160 pallas_bf16", "K1"),
            ("ab_s_gt_128", "S=256 pallas_bf16", "K1"))
    for tag, row, k in need:
        if not got[tag][row][k] > 0:
            fail(f"{tag} row {row} launched {k} {got[tag][row][k]} times")
    return got


def ab_phase(card: str) -> dict:
    """Phase 13: every AB_RUNS entry (run_drivers; each driver exits
    non-zero on its own gates) and ab_launches."""
    out = run_drivers(AB_RUNS, card)
    out["launches"] = ab_launches(out)
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
          f"mesh {em['meshes']['1x4']} {em['ms_per_iter']['1x4']} ms/iter, "
          f"solo {em['ms_per_iter']['solo']} ms/iter (cuda:0 repeated: the "
          f"mesh's four shards run one after another on one stream)")

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

    with tempfile.TemporaryDirectory() as work:
        ap = device_ahc_path(work)
    for n, w in ap["walk"].items():
        sw = ap["sweep"][n]
        one = (f", one thread {w['host_1thread_s']:.2f} s"
               if w["host_1thread_s"] is not None else "")
        old = AHC_TWO_BARRIER
        print(f"walk N={n}, D={AHC_D}: {w['ms']:.1f} ms (median of 3, one "
              f"launch, grid {w['grid']}; two-barrier design "
              f"{old['ms'][n]} ms), {w['steps']} steps, "
              f"{w['us_per_step']:.2f} us = {w['cycles_per_step']:.0f} "
              f"cycles a step (two-barrier {old['us_per_step'][n]} us); "
              f"{w['rows']} rows scanned, bound {w['bound_ms']:.1f} ms "
              f"(bytes at the HBM rate); host "
              f"f64 chain {w['host_s']:.2f} s on {os.cpu_count()} cores"
              f"{one}; sorted distances within {w['dist_err']:.2e}, labels "
              f"equal at the AHC cut and two gap cuts")
        print(f"sweep N={n} (padded {sw['n_pad']}): {sw['pass_ms']:.2f} ms "
              f"a pass (median of 5), its product {sw['matmul_ms']:.2f} ms, "
              f"bound {sw['bound_ms']:.3f} ms (operations); the whole "
              f"calibration {sw['device_s']:.3f} s (warm) vs the host "
              f"blocked sweep {sw['host_s']:.2f} s; threshold vs host "
              f"{sw['thr_err']:.2e}")
    f = ap["floor"]
    t = ap["twin"]
    b = ap["batched"]
    print(f"walk floor at N={f['n']}: {f['us_per_step']:.2f} us a step "
          f"({f['steps']} steps; two-barrier "
          f"{AHC_TWO_BARRIER['floor_us']} us)")
    for n, c in ap["cross"].items():
        print(f"walk crossover N={n}: {c['ms']:.2f} ms against the host "
              f"chain on one thread {c['host_1thread_ms']:.1f} ms "
              f"({c['host_1thread_ms'] / c['ms']:.1f}x), sorted distances "
              f"within {c['dist_err']:.2e}, labels equal")
    print(f"walk vs plain twin at N={t['n']}: {t['ms']:.2f} ms vs "
          f"{t['plain_ms']:.0f} ms, sorted distances within "
          f"{t['max_abs_err']:.2e}, labels equal at the cuts, merge pairs "
          f"equal {t['same_pairs']:.4f}, steps {t['steps']} / "
          f"{t['twin_steps']}, {t['rows']} rows scanned, bound "
          f"{t['bound_ms']:.2f} ms")
    print(f"walk batched N={b['ns']}: {b['ms']:.1f} ms one launch "
          f"(two-barrier {AHC_TWO_BARRIER['batched_ms']} ms), steps "
          f"{b['steps']}, bound "
          f"{b['bound_ms']:.1f} ms; every lane bit-equal alone and at 1 "
          f"and 2 blocks an SM; batched sweep within {AHC_THR_BAR} of the "
          f"host")
    p = ap["pre"]
    print(f"pre-stage: {len(PRE_LENGTHS)} recordings of {list(PRE_LENGTHS)} "
          f"through diarize_ark: pre_linkage_recordings "
          f"{p['pre_linkage_recordings']} in {p['pre_linkage_s']:.2f} s, "
          f"{p['walk_launches']} walk launches; init {p['init_s']}; run "
          f"{p['auto_s']:.1f} s vs 'host' {p['host_s']:.1f} s; initial "
          f"labels and RTTMs equal; 'auto' at N=10000 launched the walk "
          f"once ({ap['auto_clusters']} clusters, equal to 'host'); phase "
          f"{ap['seconds']:.1f} s")
    kernels.append({
        "name": "nn_chain_walk", "route": "cuda",
        "source": "vbx_tpu_torch/csrc/nn_chain.cu",
        "replaces": "vbx_tpu/clustering/device.py:63 (_nn_chain_batched_jit,"
                    " an XLA while_loop; no pl.pallas_call)",
        "launches": p["walk_launches"], "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "library_ms": None})

    with tempfile.TemporaryDirectory() as work:
        sp = serving_path(work)
    v = sp["service"]
    print(f"service on cuda (callhome preset, engine 'pallas'): "
          f"{v['requests']} requests from {v['threads']} threads in "
          f"{v['wall_s']:.2f} s = {v['req_per_s']:.1f} requests/s, latency "
          f"p50 {v['p50_ms']:.0f} ms p95 {v['p95_ms']:.0f} ms, "
          f"{v['batches']} batches, max batch {v['max_batch']}, K1 launches "
          f"{v['k1_launches']}; labels equal to diarize_ark's")
    a = sp["ami"]
    print(f"service AMI-length request N={a['n']}: {a['s']:.2f} s, one walk "
          f"launch, no fallback, {a['speakers']} speakers, labels equal to "
          f"the host route's")
    h = sp["http"]
    print(f"HTTP daemon: up in {h['up_s']:.1f} s, /healthz {h['healthz']}; "
          f"inline {h['inline_ms']:.0f} ms, ark, wav {h['wav_ms']:.0f} ms "
          f"({h['wav_speakers']} speakers) answered 200, overload 503, "
          f"SIGTERM drained; phase {sp['seconds']:.1f} s")

    with tempfile.TemporaryDirectory() as work:
        print_multi_host(multi_host_path(work))
        print_multi_card(multi_card_path(work))

    bp = bench_phase()
    print(f"bench_torch.py ({bp['seconds']:.1f} s): {bp['log']}")
    print(f"bench_torch.py: {json.dumps(bp['line'])}")

    dp = drivers_phase(card)
    for tag, argv, _ in DRIVER_RUNS:
        r = dp[tag]
        print(f"driver {tag} (python3 scripts/{' '.join(argv)}; "
              f"{r['seconds']:.1f} s):")
        for ln in r["lines"]:
            print(f"  {ln}")
    print(f"drivers: AMI-scale labels vs the CPU structured run "
          f"{json.dumps(dp['ami_scale']['line']['check_vs_cpu'])}; phase "
          f"{dp['seconds']:.1f} s")

    ab = ab_phase(card)
    for tag, argv, _ in AB_RUNS:
        r = ab[tag]
        print(f"A/B driver {tag} (python3 scripts/{' '.join(argv)}; "
              f"{r['seconds']:.1f} s):")
        for ln in r["lines"]:
            if ln:
                print(f"  {ln}")
    print(f"A/B drivers: kernel launches by row "
          f"{json.dumps(ab['launches'])}; phase {ab['seconds']:.1f} s")

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
