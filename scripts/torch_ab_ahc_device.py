#!/usr/bin/env python3
"""Long-recording AHC front half on the card against the host, for the
PyTorch/CUDA port (the counterpart of scripts/ab_ahc_device.py): N
x-vectors (default 50000) of D = 128 around 8 centres, ab_ahc_device.py's
generator with seed 0.

    python3 scripts/torch_ab_ahc_device.py [N] [D] [--device {cuda,cpu}]

Three parts, each on the same unit rows:
- calibration: ops.calibration.two_gmm_calib_cosine_device (the streamed
  2-GMM sweep, one pass of the N x N scores through the card an EM
  iteration), cold and warm, against the host's blocked float64 sweep
  (engine.ahc._blocked_cosine_condensed_and_thr(want_condensed=False));
  the thresholds must agree within 5e-5 (chip_smoke.py phase 8's bar);
- linkage: clustering.device.linkage_dot_avg_device (the NN-chain walk,
  csrc/nn_chain.cu, float64), cold and warm, against the host float64
  chain clustering.linkage_dot_avg: whether the merge pairs are equal,
  the largest difference of the (sorted) merge distances, which must be
  <= 1e-12, and the labels at the calibrated cut, which must be equal;
  then one more walk through clustering.device.nn_chain_walk for its
  steps and the rows it read, and the bytes bound they give;
- ahc_labels(compute_backend='host') against 'device' (the sweep and the
  walk on the card) at N' in {min(N, 8000), N}: the labels must be
  identical (ab_ahc_device.py only warns; here a mismatch exits
  non-zero).

The walk keeps its cluster sums in float64: at N = 50000 that is
50000 x 129 x 8 B ~ 52 MB, past the H100's 50 MB L2. One lane takes
clustering.device.lane_shared_bytes(N, D) bytes of a block's shared
memory (~8.7 KB at N = 50000, D = 128), which _check_walk_shape checks.
The host chain here is the cluster-sums route (O(N D) memory); the
condensed route, ~10 GB of host RAM at N = 50000, is
torch_linkage_scale_bench.py's.

Results go to stdout in ab_ahc_device.py's lines, then one JSON line
naming the card; details to stderr. With no card and no --device cpu it
exits non-zero before any work.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

import kernel_bounds  # noqa: E402
import torch_ab_common as common  # noqa: E402

THR_BAR = 5e-5          # chip_smoke.py AHC_THR_BAR
DIST_BAR = 1e-12        # chip_smoke.py AHC_PAIRS_BAR


def unit_rows(N: int, D: int) -> np.ndarray:
    """ab_ahc_device.py's x-vectors: 8 centres, seed 0, l2-normalized."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((8, D)) * 0.5
    x = centers[rng.integers(0, 8, size=N)] \
        + 0.7 * rng.standard_normal((N, D))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def cut(Z: np.ndarray, thr: float) -> np.ndarray:
    """ab_ahc_device.py's labels at the calibrated cut: distances shifted
    nonnegative, cut at -thr + the shift."""
    from vbx_tpu_torch.clustering import fcluster_by_distance

    adjust = abs(Z[:, 2].min())
    return fcluster_by_distance(
        np.c_[Z[:, :2], Z[:, 2] + adjust, Z[:, 3]], -thr + adjust)


def calibration(xn, device) -> dict:
    from vbx_tpu_torch.engine.ahc import _blocked_cosine_condensed_and_thr
    from vbx_tpu_torch.ops.calibration import two_gmm_calib_cosine_device

    thr_dev, t_cold = timed(lambda: two_gmm_calib_cosine_device(
        xn, device=device))
    _, t_warm = timed(lambda: two_gmm_calib_cosine_device(xn, device=device))
    (_, thr_host), t_host = timed(lambda: _blocked_cosine_condensed_and_thr(
        xn, want_condensed=False))
    return {"thr_device": thr_dev, "thr_host": thr_host,
            "thr_err": abs(thr_dev - thr_host), "cold_s": t_cold,
            "warm_s": t_warm, "host_s": t_host}


def linkage(xn, thr: float, device) -> dict:
    import torch

    from vbx_tpu_torch.clustering import linkage_dot_avg
    from vbx_tpu_torch.clustering.device import (linkage_dot_avg_device,
                                                 nn_chain_walk)

    N, D = xn.shape
    common.reset_launches()
    _, t_cold = timed(lambda: linkage_dot_avg_device(xn, device=device))
    Zd, t_warm = timed(lambda: linkage_dot_avg_device(xn, device=device))
    launches = common.read_launches()["walk"]
    Zh, t_host = timed(lambda: linkage_dot_avg(xn))
    lh, ld = cut(Zh, thr), cut(Zd, thr)
    sums = torch.from_numpy(np.ascontiguousarray(xn, np.float64)).to(
        device)[None]
    out, t_walk = timed(lambda: nn_chain_walk(sums, [N]))
    steps, rows = int(out[4][0]), int(out[5][0])
    return {"cold_s": t_cold, "warm_s": t_warm, "host_s": t_host,
            "pairs_equal": bool(np.array_equal(Zh[:, :2], Zd[:, :2])),
            "dist_err": float(np.abs(Zh[:, 2] - Zd[:, 2]).max()),
            "labels_equal": bool(np.array_equal(lh, ld)),
            "clusters_host": int(lh.max() + 1),
            "clusters_device": int(ld.max() + 1),
            "walk_launches": launches, "walk_s": t_walk, "steps": steps,
            "rows": rows,
            "bound_ms": kernel_bounds.walk_bound_ms(steps, rows, N, D)}


def front_half(xn, n_run: int, device) -> dict:
    from vbx_tpu_torch.engine.ahc import ahc_labels

    xs = xn[:n_run]
    lab_host, th = timed(lambda: ahc_labels(xs, 0.0,
                                            compute_backend="host"))
    common.reset_launches()
    lab_dev, td = timed(lambda: ahc_labels(xs, 0.0, compute_backend="device",
                                           device=device))
    return {"N": n_run, "host_s": th, "device_s": td,
            "same": bool(np.array_equal(lab_host, lab_dev)),
            "clusters": int(len(np.unique(lab_host))),
            "walk_launches": common.read_launches()["walk"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("N", nargs="?", type=int, default=50000)
    ap.add_argument("D", nargs="?", type=int, default=128)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from vbx_tpu_torch.utils.devices import measured_on

    on = measured_on(args.device, "torch_ab_ahc_device")
    if on is None:
        return 2
    from vbx_tpu_torch.clustering.device import (_check_walk_shape,
                                                 lane_shared_bytes)

    N, D, dev = args.N, args.D, args.device
    _check_walk_shape(N, D)
    common.log(f"device: {on}  N={N} D={D}; a lane takes "
               f"{lane_shared_bytes(N, D)} bytes of shared memory")
    xn = unit_rows(N, D)

    c = calibration(xn, dev)
    print(f"calibration N={N}: device {c['cold_s']:.1f}s cold / "
          f"{c['warm_s']:.1f}s warm vs host {c['host_s']:.1f}s "
          f"({c['host_s'] / c['warm_s']:.1f}x); |thr_dev - thr_host| = "
          f"{c['thr_err']:.2e}", flush=True)

    k = linkage(xn, c["thr_host"], dev)
    print(f"linkage N={N}: device {k['cold_s']:.1f}s cold / "
          f"{k['warm_s']:.1f}s warm vs host {k['host_s']:.1f}s "
          f"({k['host_s'] / k['warm_s']:.1f}x); merge pairs equal: "
          f"{k['pairs_equal']}, dist maxdiff {k['dist_err']:.1e}, labels at "
          f"the calibrated cut identical: {k['labels_equal']} (clusters "
          f"host={k['clusters_host']} device={k['clusters_device']})",
          flush=True)
    common.log(f"walk alone: {k['walk_s']:.3f}s, {k['steps']} steps, "
               f"{k['rows']} rows read; bytes bound {k['bound_ms']:.1f} ms "
               f"at the HBM rate; walk launches in the timed pair "
               f"{k['walk_launches']}")

    rows = []
    for n_run in sorted({min(N, 8000), N}):
        r = front_half(xn, n_run, dev)
        rows.append(r)
        print(f"ahc_labels N={n_run}: host {r['host_s']:.1f}s vs "
              f"device-front {r['device_s']:.1f}s "
              f"({r['host_s'] / r['device_s']:.1f}x); labels identical: "
              f"{r['same']} (clusters {r['clusters']})", flush=True)

    print(json.dumps({"driver": "ab_ahc_device", "device": on, "N": N,
                      "D": D, "calibration": c, "linkage": k,
                      "ahc_labels": rows}), flush=True)
    failed = []
    if not c["thr_err"] <= THR_BAR:
        failed.append(f"thresholds differ by {c['thr_err']:.2e} > "
                      f"{THR_BAR}")
    if not (k["dist_err"] <= DIST_BAR and k["labels_equal"]):
        failed.append(f"walk vs host chain: dist maxdiff "
                      f"{k['dist_err']:.2e}, labels equal "
                      f"{k['labels_equal']}")
    failed += [f"ahc_labels N={r['N']}: device labels differ from host"
               for r in rows if not r["same"]]
    if failed:
        common.log("torch_ab_ahc_device: FAILED: " + "; ".join(failed))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
