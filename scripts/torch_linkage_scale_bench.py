#!/usr/bin/env python3
"""Long-recording AHC front half of the PyTorch/CUDA port at scale (the
counterpart of scripts/linkage_scale_bench.py): blocked cosine + binned
calibration + native NN-chain linkage + flat cut at N = 10k/20k/50k
x-vectors (a 0.24 s hop puts an hour-long meeting at N ~ 15k; multi-hour
DIHARD-style files reach N ~ 50k), D = 128, 8 clusters, seed 0.

    python3 scripts/torch_linkage_scale_bench.py [N ...] [--device cpu]
    python3 scripts/torch_linkage_scale_bench.py --ondemand [N ...]

It runs the port's host chain (engine.ahc._blocked_cosine_condensed_and_
thr, then clustering.linkage(method='average') on the condensed matrix,
or with --ondemand clustering.linkage_dot_avg(backend='native')), as
linkage_scale_bench.py runs vbx_tpu's: every step is on the host. The
card's walk at these sizes is another driver's. --device only says where
the run may be (cuda, the default, needs a visible card; cpu asks for a
run with no card), so that no figure is taken for a card run that was not.

Memory note: the condensed distance matrix is N(N-1)/2 float64 — 10 GB at
N=50k. The blocked cosine path never materializes the square matrix, so
peak RSS is condensed + one row block. --ondemand runs the cluster-sums
linkage (O(N*D) memory, no condensed buffer) with the histogram-only
calibration sweep.

Results go to stdout in linkage_scale_bench.py's line, one per N, then
one JSON line; details to stderr.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

D, K = 128, 8


def xn_for(rng, N):
    """linkage_scale_bench.py's inputs: K cluster centres, N unit rows."""
    centers = rng.standard_normal((K, D))
    z = rng.integers(0, K, N)
    x = centers[z] + 0.8 * rng.standard_normal((N, D))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def front_half(xn, ondemand):
    """(labels, seconds of cosine+calib, linkage and cut): the JAX
    driver's steps on the port's host chain."""
    from vbx_tpu_torch.clustering import (fcluster_by_distance, linkage,
                                          linkage_dot_avg)
    from vbx_tpu_torch.engine import ahc

    t0 = time.perf_counter()
    cond, thr = ahc._blocked_cosine_condensed_and_thr(
        xn, want_condensed=not ondemand)
    t_front = time.perf_counter() - t0

    t0 = time.perf_counter()
    if ondemand:
        Z = linkage_dot_avg(xn, backend="native")
    else:
        Z = linkage(cond, method="average")
    t_link = time.perf_counter() - t0
    del cond

    adjust = abs(Z[:, 2].min())
    Z[:, 2] += adjust
    t0 = time.perf_counter()
    labels = fcluster_by_distance(Z, -(thr + (-0.015)) + adjust)
    t_cut = time.perf_counter() - t0
    return labels, (t_front, t_link, t_cut)


def host_ram_gb():
    """The host's physical memory, GB (figures at N = 50k need it)."""
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", type=int, nargs="*",
                    default=[10_000, 20_000, 50_000])
    ap.add_argument("--ondemand", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from vbx_tpu_torch.utils.devices import measured_on

    on = measured_on(args.device, "torch_linkage_scale_bench")
    if on is None:
        return 2
    ram = host_ram_gb()
    print(f"device: {on} (the chain runs on the host); host RAM "
          f"{ram:.1f} GB, {os.cpu_count()} cores", file=sys.stderr, flush=True)
    rng = np.random.default_rng(0)
    mode = "ondemand(O(N*D))" if args.ondemand else "condensed"
    rows = []
    for N in args.sizes:
        labels, (t_front, t_link, t_cut) = front_half(xn_for(rng, N),
                                                      args.ondemand)
        total = t_front + t_link + t_cut
        gb = (N * 128 * 8 * 2 if args.ondemand
              else N * (N - 1) / 2 * 8) / 1e9
        n_clusters = len(np.unique(labels))
        print(f"N={N} [{mode}]: cosine+calib {t_front:.1f}s, "
              f"linkage {t_link:.1f}s, cut {t_cut:.2f}s -> TOTAL {total:.1f}s "
              f"({n_clusters} clusters, buffers {gb:.2f} GB)", flush=True)
        rows.append({"N": N, "cosine_calib_s": t_front, "linkage_s": t_link,
                     "cut_s": t_cut, "total_s": total,
                     "clusters": n_clusters, "buffers_gb": gb})
    print(json.dumps({"driver": "linkage_scale", "device": on,
                      "mode": mode, "host_ram_gb": ram,
                      "cores": os.cpu_count(), "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
