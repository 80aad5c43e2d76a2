#!/usr/bin/env python3
"""Interleaved same-process A/B of the port's forward-backward
implementations on one CUDA card, at the kernel level and at the full-EM
level (the counterpart of scripts/ab_fb_kernels.py for vbx_tpu_torch).

    python3 scripts/torch_ab_fb_kernels.py [B] [T] [S] [--device cpu]

Defaults B=256, T=1025, S=31 (D=128), 7 interleaved repetitions.

- Kernel level: ops.fb_scan_kernel.fb_scan, the [T, B, S] smoother API,
  with the fused bidirectional CUDA kernel (fused=True) against the
  two-pass forward + backward kernels (fused=False); then the largest
  difference of the two routes' gamma and log-normalizers.
- EM level: engine.vbhmm.vbx_batched for 10 iterations (epsilon=-1, so
  none stops early), the kernel route (fb_impl='pallas') against the
  structured route.

It prints the card's name and power limit first. Times are CUDA-event
times of one call each; the medians of the interleaved repetitions are
what to compare, inside one run on one card. With --device cpu the
wrappers run their plain twins and the times are host times of this
machine's CPU, not device times (a rehearsal of the control flow).
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

D = 128
REPS = 7


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("B", nargs="?", type=int, default=256)
    p.add_argument("T", nargs="?", type=int, default=1025)
    p.add_argument("S", nargs="?", type=int, default=31)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain twins, host times)")
    return p


def card_line(dev) -> str:
    if dev.type != "cuda":
        return "no card: --device cpu"
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def _timed_ms(fn, dev) -> float:
    """One call of fn, in ms: CUDA events on a card, the host clock on the
    CPU."""
    import torch

    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _interleaved(fns: dict, dev) -> dict:
    """{name: sorted ms of REPS single calls}, the candidates taking turns
    after one warm-up call each (which also builds the kernels)."""
    for name, fn in fns.items():
        ms = _timed_ms(fn, dev)
        print(f"  first call {name}: {ms:.1f}ms", flush=True)
    times = {name: [] for name in fns}
    for _ in range(REPS):
        for name, fn in fns.items():
            times[name].append(_timed_ms(fn, dev))
    return {name: sorted(v) for name, v in times.items()}


def main(argv=None) -> dict:
    import torch

    from vbx_tpu_torch.device import resolve_device
    from vbx_tpu_torch.engine.vbhmm import vbx_batched
    from vbx_tpu_torch.ops import fb_kernel, fb_scan_kernel
    from vbx_tpu_torch.ops.fb_scan_kernel import fb_scan

    args = build_parser().parse_args(argv)
    B, T, S = args.B, args.T, args.S
    dev = resolve_device(args.device)
    print(f"card: {card_line(dev)}")
    print(f"device: {dev}  B={B} T={T} S={S}", flush=True)
    rng = np.random.default_rng(0)
    unit = "ms" if dev.type == "cuda" else "ms (host time on the CPU)"
    out = {"shape": [B, T, S, D], "device": str(dev)}

    def put(a):
        return torch.as_tensor(a, device=dev)

    # ---- kernel level ----
    logp = rng.normal(size=(T, B, S)).astype(np.float32)
    m = logp.max(-1)
    w = put(np.exp(logp - m[..., None]))
    valid = torch.ones((T, B), dtype=torch.float32, device=dev)
    pi = rng.dirichlet(np.ones(S), size=B).astype(np.float32)
    col = put(0.1 * pi + 1e-8)
    pinit = put(pi + 1e-8)

    def run_kernel(fused):
        return fb_scan(w, valid, col, pinit, 0.9, fused=fused)

    counters = (fb_scan_kernel.fb_scan_fused, fb_scan_kernel.fb_scan_fwd,
                fb_scan_kernel.fb_scan_bwd, fb_kernel.fb_fused_sb)
    before = [c.launches for c in counters]
    times = _interleaved({"fused=True": lambda: run_kernel(True),
                          "fused=False": lambda: run_kernel(False)}, dev)
    for name, ts in times.items():
        print(f"kernel {name}: median {statistics.median(ts):.3f}{unit}  "
              f"(all {[round(x, 3) for x in ts]})", flush=True)
    out["kernel_fused_ms"] = statistics.median(times["fused=True"])
    out["kernel_two_pass_ms"] = statistics.median(times["fused=False"])

    # numerical check fused vs two-pass
    a1, b1, c1 = run_kernel(True)
    a2, b2, c2 = run_kernel(False)
    g1 = a1 * b1 / (a1 * b1).sum(-1, keepdim=True)
    g2 = a2 * b2 / (a2 * b2).sum(-1, keepdim=True)
    out["gamma_maxdiff"] = float((g1 - g2).abs().max())
    out["lognorm_maxdiff"] = float((torch.log(c1) - torch.log(c2)).abs()
                                   .max())
    print(f"gamma maxdiff fused vs two-pass: {out['gamma_maxdiff']:.2e}  "
          f"log-normalizer maxdiff: {out['lognorm_maxdiff']:.2e}",
          flush=True)

    # ---- full EM level ----
    X = put(rng.normal(size=(B, T, D)).astype(np.float32))
    phi = put(np.linspace(2.0, 0.1, D).astype(np.float32))
    G = put(rng.dirichlet(np.ones(S), size=(B, T)).astype(np.float32))
    PI = torch.full((B, S), 1.0 / S, dtype=torch.float32, device=dev)
    FM = torch.ones((B, T), dtype=torch.bool, device=dev)
    SM = torch.ones((B, S), dtype=torch.bool, device=dev)
    kw = dict(loop_prob=0.9, Fa=0.3, Fb=17.0, max_iters=10, epsilon=-1.0,
              device=dev)

    def run_em(impl):
        return vbx_batched(X, phi, G, PI, FM, SM, fb_impl=impl, **kw)

    em_times = _interleaved({"pallas": lambda: run_em("pallas"),
                             "structured": lambda: run_em("structured")},
                            dev)
    for impl, ts in em_times.items():
        print(f"EM(10 iters) {impl}: median {statistics.median(ts):.1f}"
              f"{unit}  (all {[round(x, 1) for x in ts]})", flush=True)
        out[f"em_{impl}_ms"] = statistics.median(ts)
    out["launches"] = {c.__name__: c.launches - n
                       for c, n in zip(counters, before)}
    print(f"kernel launches: {out['launches']}", flush=True)
    return out


if __name__ == "__main__":
    main()
