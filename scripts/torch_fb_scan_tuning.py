#!/usr/bin/env python3
"""Time variants of the [T, B, S] forward-backward kernels
(vbx_tpu_torch/csrc/fb_scan_tbs.cu) on one CUDA card: other numbers of
recording lanes per block and of frames kept in flight per chain, the
walks with their stores left out, with the approximate division
`__fdividef` in place of the IEEE one, and with no loads of w inside the
loop.

    python3 scripts/torch_fb_scan_tuning.py [B] [T] [S]

Defaults B=256, T=1025, S=31 (the kernel A/B tool's shape). Each variant is
the shipped source with its two constants (kLanesPerBlock, kAhead)
replaced by text substitution, for the "nost" rows with the per-frame
stores of ahat / bhat / cfw compiled out (only the last frame's carry is
stored, so the walk itself cannot be optimized away), for the "fdiv" rows
with both normalizing divisions approximate, and for the "nold" rows with
the in-loop loads of w removed (every step reuses the first frames: the
dependent arithmetic alone). All variants are
compiled first (one nvcc each, started together), then timed in turns: the
median of 25 launches by CUDA events, three rounds. It prints the card's
name and power limit first, and at the end the SM clock nvidia-smi reads
while the shipped fused kernel runs back to back, so that a time per step
can be read as cycles. A measurement tool: nothing in the package uses
these variants (the approximate division would break the 1e-37 floor), and
only the shipped source is held to the twins (chip_smoke.py,
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

# (lanes per block, frames in flight, stores, IEEE division, loads)
VARIANTS = ((4, 4, True, True, True), (1, 4, True, True, True),
            (8, 4, True, True, True), (4, 1, True, True, True),
            (4, 8, True, True, True), (4, 4, False, True, True),
            (4, 4, True, False, True), (4, 4, False, False, True),
            (4, 4, True, True, False), (4, 4, False, True, False),
            (4, 4, False, False, False))


def variant_source(src: str, lanes: int, ahead: int, stores: bool,
                   ieee_div: bool = True, loads: bool = True) -> str:
    out = src.replace("constexpr int kLanesPerBlock = 4;",
                      f"constexpr int kLanesPerBlock = {lanes};")
    out = out.replace("constexpr int kAhead = 4;",
                      f"constexpr int kAhead = {ahead};")
    if out == src and (lanes, ahead) != (4, 4):
        raise RuntimeError("the source's constants were not found")
    if not stores:
        # keep only the final frame's stores
        out = out.replace("store_frame<KPT>(al + t * step, lane, S, carry);",
                          "if (t == T - 1) store_frame<KPT>(al + t * step, "
                          "lane, S, carry);")
        out = out.replace(
            "store_frame<KPT>(bl + (f - 1) * step, lane, S, carry);",
            "if (f == 1) store_frame<KPT>(bl + (f - 1) * step, lane, S, "
            "carry);")
        out = out.replace("if (WITH_C && lane == 0)",
                          "if (WITH_C && lane == 0 && t == T - 1)")
    if not ieee_div:
        out = out.replace("carry[k] = a[k] / c;",
                          "carry[k] = __fdividef(a[k], c);")
        out = out.replace("carry[k] = bb[k] / cb;",
                          "carry[k] = __fdividef(bb[k], cb);")
    if not loads:
        before = out
        out = out.replace("t + kAhead < T ? S : 0", "0")
        out = out.replace("f - kAhead >= 1 ? S : 0", "0")
        if out == before:
            raise RuntimeError("the source's in-loop copies were not found")
    return out


def main(argv=None) -> int:
    import torch

    from vbx_tpu_torch.ops import cuda_build

    argv = sys.argv[1:] if argv is None else argv
    B, T, S = (int(a) for a in (list(argv) + [256, 1025, 31][len(argv):]))
    if not torch.cuda.is_available():
        print("no CUDA card: this tool only measures on a card",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"T={T} B={B} S={S}", flush=True)
    src = open(cuda_build.sources()["fb_scan_tbs"]).read()
    nvcc = cuda_build._nvcc()
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]

    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.rand((T, B, S), generator=gen, device="cuda")
    pi = torch.rand((B, S), generator=gen, device="cuda")
    pi /= pi.sum(-1, keepdim=True)
    col, pinit = (0.1 * pi + 1e-8).contiguous(), (pi + 1e-8).contiguous()
    ahat, bhat = torch.empty_like(w), torch.empty_like(w)
    cfw = torch.empty((T, B), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptr = ctypes.c_void_p

    with tempfile.TemporaryDirectory() as work:
        procs = []
        for lanes, ahead, stores, ieee_div, loads in VARIANTS:
            tag = (f"l{lanes}_a{ahead}_{'st' if stores else 'nost'}"
                   f"{'' if ieee_div else '_fdiv'}{'' if loads else '_nold'}")
            cu, so = (os.path.join(work, f"{tag}.{e}") for e in ("cu", "so"))
            with open(cu, "w") as f:
                f.write(variant_source(src, lanes, ahead, stores, ieee_div,
                                       loads))
            procs.append((tag, so, subprocess.Popen(
                [nvcc, *flags, "-o", so, cu], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        calls = {}
        for tag, so, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {tag}:\n{out}")
            lib = ctypes.CDLL(so)
            for fn, n_ptr in ((lib.fb_scan_fused_launch, 6),
                              (lib.fb_scan_fwd_launch, 6),
                              (lib.fb_scan_bwd_launch, 4)):
                fn.restype = ctypes.c_int
                n_in = n_ptr - 3 if n_ptr == 6 else 2
                fn.argtypes = ([ptr] * n_in + [ctypes.c_float]
                               + [ctypes.c_int] * 3
                               + [ptr] * (n_ptr - n_in))
            p = {n: x.data_ptr() for n, x in dict(
                w=w, col=col, pinit=pinit, ahat=ahat, bhat=bhat,
                cfw=cfw).items()}
            calls[tag] = {
                "fused": lambda lib=lib: lib.fb_scan_fused_launch(
                    p["w"], p["col"], p["pinit"], 0.9, T, B, S, p["ahat"],
                    p["bhat"], stream),
                "fwd": lambda lib=lib: lib.fb_scan_fwd_launch(
                    p["w"], p["col"], p["pinit"], 0.9, T, B, S, p["ahat"],
                    p["cfw"], stream),
                "bwd": lambda lib=lib: lib.fb_scan_bwd_launch(
                    p["w"], p["col"], 0.9, T, B, S, p["bhat"], stream)}

        def cuda_ms(fn, n=25):
            for _ in range(3):
                if fn() != 0:
                    raise RuntimeError("launch failed")
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

        rows = {tag: {k: [] for k in fns} for tag, fns in calls.items()}
        for _ in range(3):
            for tag, fns in calls.items():
                for kind, fn in fns.items():
                    rows[tag][kind].append(cuda_ms(fn))
        # the SM clock under this load: queue ~1 s of the shipped fused
        # kernel and read the clock while it runs
        for _ in range(2000):
            calls["l4_a4_st"]["fused"]()
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        torch.cuda.synchronize()
    print(f"SM clock while fb_scan_fused runs back to back, and its "
          f"maximum: {clocks}")
    for tag, r in rows.items():
        print(f"{tag}: " + "  ".join(
            f"{k} {statistics.median(v):.4f} ms" for k, v in r.items()),
            flush=True)
    print(json.dumps({"card": card, "sm_clocks": clocks,
                      "shape": [T, B, S], "ms": {
        tag: {k: statistics.median(v) for k, v in r.items()}
        for tag, r in rows.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
