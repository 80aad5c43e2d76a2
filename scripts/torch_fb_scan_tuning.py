#!/usr/bin/env python3
"""Time variants of the [T, B, S] walks on one CUDA card
(vbx_tpu_torch/csrc/fb_scan_tbs.cu): K3, the fused walk, K4, the forward
walk, and K5, the backward walk, all three in their grouped-lane design.

    python3 scripts/torch_fb_scan_tuning.py [summary.json]

Each variant is the shipped source, or the header it shares with K1 and K2
(csrc/fb_step.cuh), with a few lines replaced by text substitution
(K3_VARIANTS, K4_VARIANTS, K5_VARIANTS below). For all three: no
unrolling; the IEEE reciprocal in place of the approximate one, or the
approximate one without its rare branch; the row copies removed after the
ring's first chunks (later chunks read what their buffer already holds);
the per-frame stores removed (ahat, bhat and K4's cfw; only the last frame
is stored, so the walk cannot be optimized away); 1 or 2 speakers per
thread instead of 4; 2 or 4 KB chunks instead of 8; two ring stages
instead of three; only the first row of each chunk copied, one thread
issuing all of a chunk's row copies, or one arrival on the chunk's
mbarrier in place of one a row. K3 also runs its forward chains alone and
its backward chains alone; K4 also runs without its cfw store. Together
they say what a step of each walk is made of. Variants are compiled first
(one nvcc for each distinct source, started together: 20 builds), then
timed in turns, three rounds, by
CUDA events (median of 25 launches), at the kernel A/B tool's shape
(SHAPE: T=1025, B=256, S=31). It prints the card's name and power limit
first and, last, the SM clock nvidia-smi reads while the shipped K3 runs
back to back, so that a time per step reads as cycles; the JSON summary
(its last line) is also written to the file named as the argument, if any.
A measurement tool: nothing in the package uses these variants, and only
the shipped source is held to the plain twins (chip_smoke.py,
tests/test_torch_gpu.py).
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from torch_fb_fused_tuning import (  # noqa: E402
    _IEEE_RCP, _NO_RARE_BRANCH, _NO_UNROLL, _per_thread, _ring,
    build_variants, cuda_ms, variant_source)

SHAPE = (1025, 256, 31)     # T, B, S

# A variant is (substitutions in fb_scan_tbs.cu, substitutions in
# fb_step.cuh), each a tuple of (old text, new text) that must be found.
# only the ring's first kStages chunks are ever copied (RowStager)
_NO_LOADS = (("{ return n_chunks > q; }",
              "{ return n_chunks > q && q < kStages; }"),)
_CFW_STORE = "      if (c_store) *cp = fmaxf(c_raw, kTiny);\n"
_NO_STORES = (
    ("      write_frame<float, G, P>(ap, l.g, l.s_store, carry);",
     "      write_frame<float, G, P>(ap, l.g, t == st.n_frames - 1 ? "
     "l.s_store : 0, carry);"),
    (_CFW_STORE, _CFW_STORE.replace("if (c_store)",
                                    "if (c_store && t == st.n_frames - 1)")),
    ("      write_frame<float, G, P>(bp, l.g, l.s_store, carry);",
     "      write_frame<float, G, P>(bp, l.g, f == 1 ? l.s_store : 0, "
     "carry);"))
_FWD_ONLY = (("  else\n    backward_rows", "  else if (T < 0)\n    "
              "backward_rows"),)
_BWD_ONLY = (("  if (forward)\n    forward_rows",
              "  if (forward && T < 0)\n    forward_rows"),
             ("  else\n    backward_rows", "  else if (!forward)\n    "
              "backward_rows"))
# how the rows' bulk copies cost: only the first row of each chunk copied
# (the others arrive with no copy); one thread issuing all of a chunk's
# rows; one arrival with the chunk's total bytes (a warp sum) in place of
# one arrival per row (timing only: it leaves out the single elements at
# the tensor's ends, which the A/B shape does not have)
_ROW_LOOP = """\
    for (int r = lane; r < (1 << log_f); r += 32) {
      if (r < n) {
        const uintptr_t s = row_start(t0 + r);
        // 16-byte aligned: stride = frame_stride (mod 16)
        stage_bytes<IO>(lo, hi, s, s + row_bytes,
                        slot + r * stride - (s & 15), mbar, 0, 1);
      } else {
        bulk_copy(slot, 0, 0u, mbar);  // no such row: arrive alone
      }
    }
"""
_RUN = """\
      const uintptr_t s = row_start(t0 + r);
      const uintptr_t r0 = s & ~static_cast<uintptr_t>(15);
      const uintptr_t r1 = (s + row_bytes + 15) & ~static_cast<uintptr_t>(15);
      const uintptr_t v0 = r0 < lo ? r0 + 16 : r0;
      const uintptr_t v1 = r1 > hi ? r1 - 16 : r1;
"""
_ONE_ARRIVAL_LOOP = f"""\
    const unsigned bar = smem_address(mbar);
    unsigned bytes = 0;
    for (int r = lane; r < n; r += 32) {{
{_RUN}      bytes += v1 > v0 ? static_cast<unsigned>(v1 - v0) : 0u;
    }}
    for (int o = 16; o > 0; o /= 2)
      bytes += __shfl_xor_sync(0xffffffffu, bytes, o);
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar), "r"(bytes) : "memory");
    for (int r = lane; r < n; r += 32) {{
{_RUN}      if (v1 > v0)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];"
            ::"r"(smem_address(slot + r * stride - (s & 15) + (v0 - r0))),
            "l"(v0), "r"(static_cast<unsigned>(v1 - v0)), "r"(bar)
            : "memory");
    }}
"""
_FIRST_ROW_ONLY = ((), ((_ROW_LOOP, _ROW_LOOP.replace(
    "if (r < n) {", "if (r < n && r == 0) {")),))
_ONE_THREAD_ISSUES = ((), ((_ROW_LOOP, _ROW_LOOP.replace(
    "for (int r = lane; r < (1 << log_f); r += 32)",
    "for (int r = 0; lane == 0 && r < (1 << log_f); ++r)")),))
_ONE_ARRIVAL = ((), ((_ROW_LOOP, _ONE_ARRIVAL_LOOP),
                     ("mbar_init_count(mbars + i, 1 << log_f);",
                      "mbar_init_count(mbars + i, 1);")))
# S=31 as groups of 32 and 16 threads
_ONE_PER_THREAD = _per_thread(1, (32,), "FB_SCAN_GROUP")
_TWO_PER_THREAD = _per_thread(2, (16,), "FB_SCAN_GROUP")

K5_VARIANTS = {
    "shipped": ((), ()),
    "no_unroll": (_NO_UNROLL, ()),
    "ieee_rcp": ((), _IEEE_RCP),
    "no_rare_branch": ((), _NO_RARE_BRANCH),
    "no_loads": ((), _NO_LOADS),
    "no_stores": (_NO_STORES, ()),
    "no_loads_no_stores": (_NO_STORES, _NO_LOADS),
    "1_per_thread": _ONE_PER_THREAD,
    "2_per_thread": _TWO_PER_THREAD,
    "chunk_2k": _ring(3, 2048, 32),
    "chunk_4k": _ring(3, 4096, 64),
    "2_stages": _ring(2, 8192),
    "first_row_only": _FIRST_ROW_ONLY,
    "one_thread_issues": _ONE_THREAD_ISSUES,
    "one_arrival": _ONE_ARRIVAL,
}

K3_VARIANTS = {
    **K5_VARIANTS,
    "fwd_only": (_FWD_ONLY, ()),
    "bwd_only": (_BWD_ONLY, ()),
    "fwd_only_no_loads_no_stores": (_FWD_ONLY + _NO_STORES, _NO_LOADS),
    "bwd_only_no_loads_no_stores": (_BWD_ONLY + _NO_STORES, _NO_LOADS),
}


# K4 is K3's forward chain with the cfw store: K5's variants, and one
# without that store
K4_VARIANTS = {**K5_VARIANTS, "no_cfw": (((_CFW_STORE, ""),), ())}

# kernel: (its variants, its C entry point)
KERNELS = {"K3 fb_scan_fused": (K3_VARIANTS, "fb_scan_fused_launch"),
           "K4 fb_scan_fwd": (K4_VARIANTS, "fb_scan_fwd_launch"),
           "K5 fb_scan_bwd": (K5_VARIANTS, "fb_scan_bwd_launch")}


def distinct_builds():
    """{build tag: (substitutions)} with one build for each distinct pair of
    substitution lists, and {(kernel, variant): build tag}."""
    builds, which = {}, {}
    by_subs = {}
    for kernel, (variants, _) in KERNELS.items():
        for tag, subs in variants.items():
            key = repr(subs)
            if key not in by_subs:
                by_subs[key] = f"v{len(by_subs)}"
                builds[by_subs[key]] = subs
            which[(kernel, tag)] = by_subs[key]
    return builds, which


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: this tool only measures on a card",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    T, B, S = SHAPE
    print(f"T={T} B={B} S={S}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.rand((T, B, S), generator=gen, device="cuda")
    pi = torch.rand((B, S), generator=gen, device="cuda")
    pi /= pi.sum(-1, keepdim=True)
    col, pinit = (0.1 * pi + 1e-8).contiguous(), (pi + 1e-8).contiguous()
    ahat, bhat = torch.empty_like(w), torch.empty_like(w)
    cfw = torch.empty((T, B), device="cuda")
    p = {n: x.data_ptr() for n, x in dict(
        w=w, col=col, pinit=pinit, ahat=ahat, bhat=bhat, cfw=cfw).items()}
    args = {"fb_scan_fused_launch": (p["w"], p["col"], p["pinit"], 0.9, T, B,
                                     S, p["ahat"], p["bhat"], stream),
            "fb_scan_fwd_launch": (p["w"], p["col"], p["pinit"], 0.9, T, B,
                                   S, p["ahat"], p["cfw"], stream),
            "fb_scan_bwd_launch": (p["w"], p["col"], 0.9, T, B, S, p["bhat"],
                                   stream)}
    n_in = {"fb_scan_fused_launch": 3, "fb_scan_fwd_launch": 3,
            "fb_scan_bwd_launch": 2}

    builds, which = distinct_builds()
    with tempfile.TemporaryDirectory() as work:
        libs = {}
        for tag, so, proc in build_variants(work, "fb_scan_tbs", builds):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {tag}:\n{out}")
            libs[tag] = ctypes.CDLL(so)
        calls = {}     # {kernel: {variant: launch}}
        for (kernel, tag), build in which.items():
            entry = KERNELS[kernel][1]
            fn = getattr(libs[build], entry)
            fn.restype = c_int
            fn.argtypes = ([ptr] * n_in[entry] + [ctypes.c_float]
                           + [c_int] * 3
                           + [ptr] * (len(args[entry]) - n_in[entry] - 4))
            calls.setdefault(kernel, {})[tag] = (
                lambda fn=fn, a=args[entry]: fn(*a))
        times = {k: {tag: [] for tag in v} for k, v in calls.items()}
        for _ in range(3):
            for k, v in calls.items():
                for tag, fn in v.items():
                    times[k][tag].append(cuda_ms(fn, 25))
        # the SM clock under this load: queue ~1 s of the shipped K3 and
        # read the clock while it runs
        shipped = calls["K3 fb_scan_fused"]["shipped"]
        for _ in range(3000):
            shipped()
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        torch.cuda.synchronize()
    print(f"SM clock while K3 runs back to back, and its maximum: {clocks}")
    mhz = float(clocks.split()[0])
    result = {}
    for k, v in times.items():
        print(k)
        result[k] = {}
        for tag, ts in v.items():
            if None in ts:
                result[k][tag] = None
                print(f"  {tag}: launch refused")
                continue
            ms = statistics.median(ts)
            result[k][tag] = ms
            print(f"  {tag}: {ms:.4f} ms  ({ms * 1e3 * mhz / T:.0f} cycles a "
                  f"step; rounds {' '.join(f'{t:.4f}' for t in ts)})",
                  flush=True)
    summary = json.dumps({"card": card, "sm_clocks": clocks,
                          "shape": list(SHAPE), "ms": result})
    print(summary)
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        with open(argv[0], "w") as f:
            f.write(summary + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
