#!/usr/bin/env python3
"""Multi-device scaling efficiency of the port's sharded VB engine
(parallel.engine.vbx_sharded; the counterpart of scripts/scaling_bench.py).

It runs on the visible cards: with several, the mesh takes them in order;
with one, it repeats cuda:0 to SCALING_DEVICES entries (default 4), as
the multi-device dryrun does, and its note says that such a run checks
the shard plumbing and measures no scaling (the shards of a mesh of one
card run one after another on one stream). With --device cpu the mesh
is SCALING_DEVICES copies of the CPU.

Two measurements, both at a fixed per-run EM iteration count
(epsilon=-1 disables early convergence — the engine freezes a recording
when delta-ELBO < epsilon, and float32 deltas can quantize negative, so
epsilon=0 would NOT guarantee identical work in every configuration):

- dp weak scaling: B grows with the device count (recordings are
  embarrassingly parallel; the reference's per-recording fan-out axis,
  AMI_run.sh:53-58). Efficiency = t(1 dev, B0) / t(N dev, N*B0).
- sp strong scaling: one batch of long recordings, frame axis split over
  devices (blockwise forward-backward boundary exchange + summed M-step
  statistics). Efficiency = t(1 dev) / (N * t(N dev)).

Shape T = 4096, S = 8, D = 128, B0 = 4; 5 iterations; the median of 5
timed runs after one warm-up. Each mesh's labels (gamma's argmax) must
agree with the solo engine (engine.vbhmm.vbx_batched on the mesh's first
device, the same inputs) on >= 99.5% of frames (chip_smoke.py phase 5's
bar), or it exits non-zero.

    python3 scripts/torch_scaling_bench.py [--T T] [--device cpu]
    SCALING_DEVICES=2 python3 scripts/torch_scaling_bench.py

Details go to stderr; the last line of stdout is scaling_bench.py's JSON
object (platform, n_devices, physical_cores, iters, note, rows).
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

B0, T_DEFAULT, S, D = 4, 4096, 8, 128
ITERS = 5
REPS = 5
SOLO_AGREEMENT = 0.995          # chip_smoke.py MESH_AGREE['pallas']
HP = dict(loop_prob=0.9, Fa=0.3, Fb=17.0, max_iters=ITERS, epsilon=-1.0)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def mesh_devices(device, n_dev):
    """The devices a mesh may take: the visible cards, or cuda:0 (the
    CPU with device='cpu') repeated n_dev times. Returns (devices,
    repeated)."""
    import torch

    if device == "cuda" and torch.cuda.device_count() > 1:
        return ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())], False)
    return [torch.device(device, 0) if device == "cuda"
            else torch.device("cpu")] * n_dev, True


def make_inputs(rng, B, T, dev):
    import torch
    from scipy.special import softmax

    x = rng.standard_normal((B, T, D)).astype(np.float32)
    q = softmax(rng.standard_normal((B, T, S)).astype(np.float32) * 3,
                axis=-1)
    phi = np.abs(rng.standard_normal(D)).astype(np.float32)

    def put(a):
        return torch.as_tensor(a, device=dev)

    return (put(x), put(phi), put(q),
            torch.full((B, S), 1.0 / S, dtype=torch.float32, device=dev),
            torch.ones((B, T), dtype=torch.bool, device=dev),
            torch.ones((B, S), dtype=torch.bool, device=dev))


def _sync(devs):
    import torch

    for d in {d for d in devs if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def timed_run(mesh, args, reps=REPS):
    """(median seconds of `reps` runs after a warm-up, the last run's
    gamma)."""
    from vbx_tpu_torch.parallel.engine import vbx_sharded

    devs = [d for row in mesh.devices for d in row]

    def run():
        res = vbx_sharded(mesh, *args, **HP)
        _sync(devs)
        return res

    res = run()                                  # warm-up
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = run()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), res.gamma


def solo_agreement(args, gamma, dev):
    """Share of frames whose argmax label equals the solo engine's on the
    same inputs."""
    from vbx_tpu_torch.engine.vbhmm import vbx_batched

    solo = vbx_batched(*args, device=dev, **HP).gamma
    return float((solo.argmax(-1) == gamma.to(solo.device).argmax(-1))
                 .float().mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--T", type=int, default=T_DEFAULT,
                    help=f"frames a recording (default {T_DEFAULT})")
    ap.add_argument("--reps", type=int, default=REPS,
                    help=f"timed runs a configuration (default {REPS})")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from vbx_tpu_torch.utils.devices import measured_on

    on = measured_on(args.device, "torch_scaling_bench")
    if on is None:
        return 2
    from vbx_tpu_torch.parallel.mesh import make_mesh

    n_env = int(os.environ.get("SCALING_DEVICES", "4"))
    devs, repeated = mesh_devices(args.device, n_env)
    log(f"devices: {len(devs)} x {devs[0]} ({on})"
        + (" repeated" if repeated else ""))
    ncpu = os.cpu_count() or 1
    rng = np.random.default_rng(0)
    T = args.T
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devs)]
    rows, worst = [], 1.0

    def measure(axis, n, B, base_t):
        nonlocal worst
        mesh = make_mesh(n_dp=n if axis == "dp" else 1,
                         n_sp=n if axis == "sp" else 1, devices=devs[:n])
        inputs = make_inputs(rng, B, T, devs[0])
        t, gamma = timed_run(mesh, inputs, args.reps)
        agree = solo_agreement(inputs, gamma, devs[0])
        worst = min(worst, agree)
        base_t = t if base_t is None else base_t
        eff = base_t / t if axis == "dp" else base_t / (n * t)
        rows.append({"axis": axis, "devices": n, "B": B, "T": T,
                     "seconds": round(t, 4), "efficiency": round(eff, 3),
                     "agreement_vs_solo": agree})
        log(f"{axis}  n={n:2d} B={B:3d} t={t:.3f}s eff={eff:.2f} "
            f"agreement vs solo {agree:.4f}")
        return base_t

    base_t = None                    # dp weak scaling: B = B0 * n
    for n in sizes:
        base_t = measure("dp", n, B0 * n, base_t)
    base_t = None                    # sp strong scaling: frames split n ways
    for n in sizes:
        base_t = measure("sp", n, B0, base_t)

    if args.device == "cpu":
        note = ("CPU copies validate the shard plumbing, not device "
                "scaling; efficiency saturates at the physical core count")
    elif repeated:
        note = (f"one card: cuda:0 repeated {len(devs)} times checks the "
                f"shard plumbing and measures no scaling (the shards run "
                f"one after another on one stream)")
    else:
        note = "hardware measurement"
    print(json.dumps({
        "platform": "cpu" if args.device == "cpu" else "gpu",
        "n_devices": len(devs), "physical_cores": ncpu, "iters": ITERS,
        "note": note, "rows": rows, "device": on}), flush=True)
    if worst < SOLO_AGREEMENT:
        log(f"torch_scaling_bench: FAILED: a mesh's labels agree with the "
            f"solo engine on {worst:.4f} < {SOLO_AGREEMENT} of frames")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
