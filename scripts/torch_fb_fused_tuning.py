#!/usr/bin/env python3
"""Time variants of the [B, T, S] walks on one CUDA card: K1, the fused
forward-backward walk (vbx_tpu_torch/csrc/fb_fused_sb.cu), and K2, the
block-operator walk (vbx_tpu_torch/csrc/fb_fwd_product_sb.cu).

    python3 scripts/torch_fb_fused_tuning.py [summary.json]

Each variant is the shipped source, or the header the two share
(csrc/fb_step.cuh), with a few lines replaced by text substitution
(K1_VARIANTS, K2_VARIANTS below): no unrolling; the IEEE reciprocal in
place of the approximate one, or the approximate one without its rare
branch to the IEEE division; the copies of w removed after the ring's
first chunks (later chunks read what their buffer already holds); the
per-frame stores removed (only the last frame is stored, so the walk
cannot be optimized away); the forward chain alone and the backward chain
alone (the other block returns at once); 1, 2 or 8 speakers per thread
instead of 4; other ring depths and chunk sizes; K2 with a logf on every
chunk. Together they say what a step of each walk is made of. All
variants are compiled first (one nvcc each, started together), then timed
in turns, three rounds, by CUDA events: K1 in float32 and bfloat16 at
K1_SHAPES (the bench shape B=256, T=1025, S=31 and the solo long recording
B=4, T=32768, S=8) and K2 at its shard shape (B=4, Tb=8192, S=8, R=16). A
variant whose ring does not fit the card's shared memory at a shape reads
"launch refused". It prints the card's name and power limit first and,
last, the SM clock nvidia-smi reads while the shipped K1 runs back to
back, so that a time per step reads as cycles; the JSON summary (its last
line) is also written to the file named as the argument, if any. A
measurement tool: nothing in the package uses these variants, and only the
shipped sources are held to the plain twins (chip_smoke.py,
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

K1_SHAPES = (("bench", 256, 1025, 31), ("long", 4, 32768, 8))
K2_SHAPE = (4, 8192, 8, 16)     # B, Tb, S, R

# A variant is (substitutions in the .cu source, substitutions in
# fb_step.cuh), each a tuple of (old text, new text) that must be found.
# only the ring's first kStages chunks are ever copied: every later chunk
# reads what its buffer already holds (a header substitution)
_NO_LOADS = (("{ return q < n_chunks; }",
              "{ return q < n_chunks && q < kStages; }"),)
_K1_NO_STORES = (
    ("        write_frame<IO, G, P>(ap, g, s_store, carry);\n"
     "        if (g == 0 && lane_ok) *cp = c;",
     "        write_frame<IO, G, P>(ap, g, t == T - 1 ? s_store : 0, carry);\n"
     "        if (g == 0 && lane_ok && t == T - 1) *cp = c;"),
    ("        write_frame<IO, G, P>(bp, g, s_store, carry);",
     "        write_frame<IO, G, P>(bp, g, f == 1 ? s_store : 0, carry);"))
_K1_FWD_ONLY = (("    if (T < 2) return;", "    if (T < 2 || T > 0) return;"),)
_K1_BWD_ONLY = (("  if (forward) {\n", "  if (forward) {\n    if (T > 0) "
                 "return;\n"),)
_IEEE_RCP = (("  asm(\"rcp.approx.ftz.f32 %0, %1;\" : \"=f\"(r) : \"f\"(c));\n",
              "  r = 1.f / c;\n"),)


def _per_thread(p, groups, macro):
    """P speakers per thread for S <= 128, with the instances it needs."""
    return (((f"  {macro}(1, 4)\n", f"  {macro}(1, 4)\n" + "".join(
        f"  {macro}({g}, {p})\n" for g in groups)),),
            (("*P = S <= 128 ? 4 : 8;", f"*P = S <= 128 ? {p} : 8;"),))


def _ring(stages, chunk_bytes, max_frames=128):
    return ((), (("constexpr int kStages = 3;",
                  f"constexpr int kStages = {stages};"),
                 ("constexpr int kChunkBytes = 8192;",
                  f"constexpr int kChunkBytes = {chunk_bytes};"),
                 ("constexpr int kMaxChunkFrames = 128;",
                  f"constexpr int kMaxChunkFrames = {max_frames};")))


_NO_UNROLL = (("#pragma unroll 4", "#pragma unroll 1"),)
# the approximate reciprocal everywhere, without the branch to the IEEE
# division at the floor and for absurd sums
_NO_RARE_BRANCH = (("  if ((floor_exact && !(c_raw > kTiny)) || c_raw >= kHuge) "
                    "r = 1.f / c;\n", ""),)


K1_VARIANTS = {
    "shipped": ((), ()),
    "no_unroll": (_NO_UNROLL, ()),
    "no_rare_branch": ((), _NO_RARE_BRANCH),
    "no_loads": ((), _NO_LOADS),
    "no_stores": (_K1_NO_STORES, ()),
    "no_loads_no_stores": (_K1_NO_STORES, _NO_LOADS),
    "fwd_only": (_K1_FWD_ONLY, ()),
    "bwd_only": (_K1_BWD_ONLY, ()),
    "fwd_only_no_loads_no_stores": (
        _K1_FWD_ONLY + _K1_NO_STORES[:1], _NO_LOADS),
    "bwd_only_no_loads_no_stores": (
        _K1_BWD_ONLY + _K1_NO_STORES[1:], _NO_LOADS),
    "ieee_rcp": ((), _IEEE_RCP),
    # S=31 / S=8 as groups of 32 / 8, 16 / 4 and 4 / 1 threads
    "1_per_thread": _per_thread(1, (32, 8), "FB_NARROW"),
    "2_per_thread": _per_thread(2, (16, 4), "FB_NARROW"),
    "8_per_thread": _per_thread(8, (4, 1), "FB_NARROW"),
    "2_stages": _ring(2, 8192),
    "chunk_2k": _ring(3, 2048, 32),
    "chunk_4k": _ring(3, 4096, 64),
}

K2_VARIANTS = {
    "shipped": ((), ()),
    "no_loads": ((), _NO_LOADS),
    "no_unroll": (_NO_UNROLL, ()),
    "no_rare_branch": ((), _NO_RARE_BRANCH),
    "log_every_chunk": ((("constexpr int kLogEvery = 32;",
                         "constexpr int kLogEvery = 1;"),), ()),
    "ieee_rcp": ((), _IEEE_RCP),
    "1_per_thread": _per_thread(1, (32, 8), "FB_GROUP"),
    "2_per_thread": _per_thread(2, (16, 4), "FB_GROUP"),
    "2_stages": _ring(2, 8192),
    "chunk_2k": _ring(3, 2048, 32),
}


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"text to replace not found in the source: "
                               f"{old!r}")
        src = src.replace(old, new)
    return src


def cuda_ms(fn, n):
    """Median of n single-launch CUDA-event timings after a warm-up; None
    where the launch is refused (a variant whose ring does not fit the
    card's shared memory at this shape)."""
    import torch

    for _ in range(2):
        if fn() != 0:
            return None
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


def build_variants(work, name, variants):
    """Compile every variant of csrc/<name>.cu, each in a directory of its
    own beside its copy of fb_step.cuh, all nvcc processes started together;
    [(tag, library path, process)]."""
    from vbx_tpu_torch.ops import cuda_build

    src = open(cuda_build.sources()[name]).read()
    header = open(os.path.join(cuda_build.CSRC_DIR, "fb_step.cuh")).read()
    nvcc = cuda_build._nvcc()
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = []
    for tag, (src_subs, header_subs) in variants.items():
        d = os.path.join(work, f"{name}_{tag}")
        os.makedirs(d)
        cu, so = os.path.join(d, f"{name}.cu"), os.path.join(d, "lib.so")
        with open(cu, "w") as f:
            f.write(variant_source(src, src_subs))
        with open(os.path.join(d, "fb_step.cuh"), "w") as f:
            f.write(variant_source(header, header_subs))
        procs.append((tag, so, subprocess.Popen(
            [nvcc, *flags, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return procs


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
    stream = torch.cuda.current_stream().cuda_stream
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(B, T, S, io):
        w = torch.rand((B, T, S), generator=gen, device="cuda").to(io)
        pi = torch.rand((B, S), generator=gen, device="cuda")
        pi /= pi.sum(-1, keepdim=True)
        return w, (0.01 * pi + 1e-8).contiguous(), (pi + 1e-8).contiguous()

    with tempfile.TemporaryDirectory() as work:
        p1 = build_variants(work, "fb_fused_sb", K1_VARIANTS)
        p2 = build_variants(work, "fb_fwd_product_sb", K2_VARIANTS)
        libs = {}
        for tag, so, proc in p1 + p2:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {so}:\n{out}")
            libs[so] = ctypes.CDLL(so)

        calls = {}     # {row name: {variant tag: launch}}
        keep = []
        for sname, B, T, S in K1_SHAPES:
            for io in (torch.float32, torch.bfloat16):
                w, col, pinit = inputs(B, T, S, io)
                binit = torch.full((B, S), 1.0 / S, device="cuda")
                ahat, bhat = torch.empty_like(w), torch.empty_like(w)
                cfw = torch.empty((B, T), device="cuda")
                keep.append((w, col, pinit, binit, ahat, bhat, cfw))
                row = calls.setdefault(
                    f"K1 {sname} B={B} T={T} S={S} "
                    f"{str(io).replace('torch.', '')}", {})
                for tag, so, _ in p1:
                    fn = libs[so].fb_fused_sb_launch
                    fn.restype = c_int
                    fn.argtypes = ([ptr] * 4 + [ctypes.c_float] + [c_int] * 6
                                   + [ptr] * 4)
                    a = (w.data_ptr(), col.data_ptr(), pinit.data_ptr(),
                         binit.data_ptr(), 0.99, B, T, S,
                         int(io == torch.bfloat16), 1, 0, ahat.data_ptr(),
                         bhat.data_ptr(), cfw.data_ptr(), stream)
                    row[tag] = (lambda fn=fn, a=a: fn(*a))
        B, Tb, S, R = K2_SHAPE
        eye = torch.eye(S, device="cuda")
        for io in (torch.float32, torch.bfloat16):
            w, col, _ = inputs(B, Tb, S, io)
            finit = (0.99 * eye + col[:, None, :]).expand(R, B, S, S).clone()
            fhat = torch.empty_like(finit)
            ls = torch.empty((R, B, S), device="cuda")
            keep.append((w, col, finit, fhat, ls))
            row = calls.setdefault(
                f"K2 shard B={B} Tb={Tb} S={S} R={R} "
                f"{str(io).replace('torch.', '')}", {})
            for tag, so, _ in p2:
                fn = libs[so].fb_fwd_product_sb_launch
                fn.restype = c_int
                fn.argtypes = ([ptr] * 3 + [ctypes.c_float] + [c_int] * 5
                               + [ptr] * 3)
                a = (w.data_ptr(), col.data_ptr(), finit.data_ptr(), 0.99, R,
                     B, Tb, S, int(io == torch.bfloat16), fhat.data_ptr(),
                     ls.data_ptr(), stream)
                row[tag] = (lambda fn=fn, a=a: fn(*a))

        times = {r: {tag: [] for tag in v} for r, v in calls.items()}
        for _ in range(3):
            for r, v in calls.items():
                for tag, fn in v.items():
                    times[r][tag].append(
                        cuda_ms(fn, 7 if " long " in r else 25))
        # the SM clock under this load: queue ~1 s of the shipped K1 at the
        # bench shape and read the clock while it runs
        bench = next(iter(calls.values()))["shipped"]
        for _ in range(3000):
            bench()
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        torch.cuda.synchronize()
    print(f"SM clock while K1 runs back to back, and its maximum: {clocks}")
    mhz = float(clocks.split()[0])
    result = {}
    for r, v in times.items():
        steps = K2_SHAPE[1] // K2_SHAPE[3] if r.startswith("K2") else int(
            r.split("T=")[1].split()[0])
        print(r)
        result[r] = {}
        for tag, ts in v.items():
            if None in ts:
                result[r][tag] = None
                print(f"  {tag}: launch refused")
                continue
            ms = statistics.median(ts)
            cyc = ms * 1e-3 * mhz * 1e6 / steps
            result[r][tag] = ms
            print(f"  {tag}: {ms:.4f} ms  ({cyc:.0f} cycles a step; rounds "
                  f"{' '.join(f'{t:.4f}' for t in ts)})", flush=True)
    summary = json.dumps({"card": card, "sm_clocks": clocks, "ms": result})
    print(summary)
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        with open(argv[0], "w") as f:
            f.write(summary + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
