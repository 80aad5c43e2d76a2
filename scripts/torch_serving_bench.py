#!/usr/bin/env python3
"""Serving load test of the PyTorch/CUDA port: requests/s and latency
percentiles for the warm service under concurrent load (the counterpart
of scripts/serving_bench.py).

Drives vbx_tpu_torch.serving.DiarizationService in-process (the HTTP
layer adds only JSON/socket overhead): N total requests from K client
threads against one card. The request body is the bench recording of
vbx_tpu_torch.testing.write_bench_recording (seed 120: 1025 x 256-d
x-vectors shaped like the reference's ES2005a, 31 AHC clusters, 5
speakers), with its synthetic PLDA and transform.h5 (ES2005a and VBx's
models are not in the repository). Every result is a host array when its
future resolves, so the wall time covers the device work.

    python3 scripts/torch_serving_bench.py [N] [K] [fb_impl]
        [--partial-ms X] [--ahc-device] [--no-bucket-warmup] [--ab]
        [--engines] [--device {cuda,cpu}]

N=256, K=16 by default; fb_impl defaults to the service's own pick for
the example preset (an explicit engine name pins one, and a CPU run uses
the engine asked for: it is named on stderr).

--ab: same-process ABBA (partial launches off/on/on/off, N requests per
phase).
--engines: the mirrored pallas_f32 / bf16_run_to_max / bf16_cap12 phases
(engine-of-record A/B for a serving daemon).
--partial-ms: head-of-line bound for partial chunk launches (service
default 50; inf = wait for the cohort).
--ahc-device: AHCConfig.compute_backend='device' (labels may differ at
tied merges, so the warm-up's speaker count is reported, not asserted).

Checks: the warm-up keeps 5 speakers (unless --ahc-device), and every
served request's labels equal diarize_ark's on the same recording with
the same engine; it exits non-zero otherwise. Results go to stdout in
serving_bench.py's lines (with the stage attribution from the service
runlog), then one JSON line; details to stderr. With no card and no
--device cpu it exits non-zero.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

GOLDEN_SPEAKERS = 5


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _stage_attribution(runlog_path, label=""):
    """Per-stage latency breakdown from the service runlog: init (submit ->
    host init done), queued (init done -> device launch), device+fetch
    (launch -> result). Printed at p50/p95 so a tail is root-caused in the
    artifact itself (serving_bench.py's function)."""
    try:
        with open(runlog_path) as f:
            recs = [json.loads(ln) for ln in f if ln.strip()]
    except OSError:
        return
    rows = [(r["wall_ms"], r.get("init_done_ms"), r.get("launched_ms"))
            for r in recs if r.get("event") == "request"
            and not str(r.get("recording", "")).startswith("__warmup")]
    rows = [(w, i, la) for w, i, la in rows
            if i is not None and la is not None]
    if not rows:
        return
    arr = np.asarray(rows, np.float64)
    init, queued, device = (arr[:, 1], arr[:, 2] - arr[:, 1],
                            arr[:, 0] - arr[:, 2])

    def pct(x, q):
        return float(np.sort(x)[int(len(x) * q)])

    print(f"{label}stage attribution (p50/p95 ms): "
          f"init {pct(init, .5):.0f}/{pct(init, .95):.0f}, "
          f"queued {pct(queued, .5):.0f}/{pct(queued, .95):.0f}, "
          f"device+fetch {pct(device, .5):.0f}/{pct(device, .95):.0f} "
          f"({len(rows)} requests)", flush=True)
    return {"init_ms": [pct(init, .5), pct(init, .95)],
            "queued_ms": [pct(queued, .5), pct(queued, .95)],
            "device_fetch_ms": [pct(device, .5), pct(device, .95)]}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("N", type=int, nargs="?", default=256)
    ap.add_argument("K", type=int, nargs="?", default=16)
    ap.add_argument("fb_impl", nargs="?", default=None)
    ap.add_argument("--partial-ms", type=float, default=50.0)
    ap.add_argument("--ahc-device", action="store_true")
    ap.add_argument("--no-bucket-warmup", action="store_true")
    ap.add_argument("--ab", action="store_true")
    ap.add_argument("--engines", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def main(argv=None) -> int:
    from concurrent.futures import ThreadPoolExecutor

    args = build_parser().parse_args(argv)
    from vbx_tpu_torch.utils.devices import measured_on

    on = measured_on(args.device, "torch_serving_bench")
    if on is None:
        return 2
    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.engine.pipeline import diarize_ark
    from vbx_tpu_torch.io.ark import read_vec_ark_grouped
    from vbx_tpu_torch.io.segments import read_xvector_timing_dict
    from vbx_tpu_torch.serving import DiarizationService
    from vbx_tpu_torch.testing import write_bench_recording

    N, K = args.N, args.K
    work = tempfile.TemporaryDirectory()
    rec = write_bench_recording(os.path.join(work.name, "bench"))
    _, _, x_raw = next(read_vec_ark_grouped(rec["ark"]))
    _, times = read_xvector_timing_dict(rec["segments"])["bench"]

    cfg = get_preset("example")
    if args.ahc_device:
        cfg = cfg.replace(ahc=dataclasses.replace(
            cfg.ahc, compute_backend="device"))
    refs = {}
    failures = []

    def reference(c, fb):
        """diarize_ark's labels for the request body under (c, fb)."""
        key = (id(c), fb)
        if key not in refs:
            out = diarize_ark(rec["ark"], rec["segments"],
                              os.path.join(work.name, f"ref{len(refs)}"), c,
                              rec["plda"], rec["transform"], verbose=False,
                              fb_impl=fb, device=args.device)
            refs[key] = out["bench"].labels1st
        return refs[key]

    def run_phase(partial_ms, n, label="", cfg_run=None, fb_run="unset"):
        c = cfg if cfg_run is None else cfg_run
        runlog_path = os.environ.get("VBX_TPU_SERVE_RUNLOG") or os.path.join(
            tempfile.mkdtemp(dir=work.name), "serve.jsonl")
        svc = DiarizationService.from_files(
            c, rec["plda"], rec["transform"],
            fb_impl=args.fb_impl if fb_run == "unset" else fb_run,
            partial_after_ms=partial_ms, runlog_path=runlog_path,
            device=args.device)
        engine = svc._fb_impl or "structured"
        log(f"{label}device: {on}  N={n} clients={K} engine={engine} "
            f"partial_ms={partial_ms} ahc_device={args.ahc_device}")
        try:
            r = svc.diarize("warmup", x_raw, times, timeout=600)  # build
            if args.ahc_device:
                # device-dtype scores can legitimately shift tied merges;
                # report instead of asserting the golden count
                log(f"warmup speakers={r.n_speakers} (golden host path: "
                    f"{GOLDEN_SPEAKERS})")
            elif r.n_speakers != GOLDEN_SPEAKERS:
                failures.append(f"{label}warm-up kept {r.n_speakers} "
                                f"speakers, not {GOLDEN_SPEAKERS}")
            log(f"warmup: {r.wall_ms:.0f} ms (kernel build included), "
                f"{r.n_speakers} speakers")
            if not args.no_bucket_warmup:
                # warm every power-of-two batch bucket the load will ride
                # with the real request body; warmup() suspends partial
                # launches so each wave loads exactly its padded batch
                t0 = time.perf_counter()
                svc.warmup(batch_sizes=(2, 4, 8, 16), payload=(x_raw, times))
                log(f"bucket warmup (B=2..16): "
                    f"{time.perf_counter() - t0:.1f}s")

            def one(i):
                return svc.diarize(f"req{i}", x_raw, times, timeout=600)

            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=K) as pool:
                res = list(pool.map(one, range(n)))
            wall = time.perf_counter() - t0
            stats = svc.stats()
        finally:
            svc.close()
        ref = reference(c, svc._fb_impl)
        differ = sum(not np.array_equal(r.labels1st, ref) for r in res)
        if differ:
            failures.append(f"{label}{differ} of {n} requests' labels "
                            f"differ from diarize_ark's")
        lat = np.sort(np.asarray([r.wall_ms for r in res]))
        sizes = [r.batch_size for r in res]
        p = {q: float(lat[int(len(lat) * q / 100)]) for q in (50, 95, 99)}
        print(f"{label}served {n} requests in {wall:.2f}s -> "
              f"{n / wall:.1f} req/s; "
              f"latency p50={p[50]:.0f}ms p95={p[95]:.0f}ms "
              f"p99={p[99]:.0f}ms; "
              f"mean device batch={np.mean(sizes):.1f} "
              f"(batches={stats['batches']}, "
              f"max_batch={stats['max_batch']})", flush=True)
        stages = _stage_attribution(runlog_path, label)
        phases.append({"label": label.strip(), "engine": engine,
                       "partial_ms": partial_ms, "requests": n,
                       "wall_s": wall, "req_per_s": n / wall,
                       "p50_ms": p[50], "p95_ms": p[95], "p99_ms": p[99],
                       "mean_batch": float(np.mean(sizes)),
                       "batches": stats["batches"],
                       "max_batch": stats["max_batch"], "stages": stages,
                       "labels_differ": differ})
        return n / wall, p[95]

    phases = []
    try:
        if args.ab:
            # same-process ABBA: partial launches off/on/on/off
            inf = float("inf")
            pm = args.partial_ms
            a1 = run_phase(inf, N, "[A: partial off] ")
            b1 = run_phase(pm, N, f"[B: partial {pm}ms] ")
            b2 = run_phase(pm, N, f"[B: partial {pm}ms] ")
            a2 = run_phase(inf, N, "[A: partial off] ")
            print(f"A/B p95: off {min(a1[1], a2[1]):.0f}ms vs "
                  f"partial {min(b1[1], b2[1]):.0f}ms; req/s: off "
                  f"{max(a1[0], a2[0]):.1f} vs partial "
                  f"{max(b1[0], b2[0]):.1f} (best of 2 each)", flush=True)
        elif args.engines:
            # which engine should a serving daemon default to? Phases run
            # same-process (a fresh service each) in a mirrored sequence:
            # f32 / bf16-max / bf16-cap12 / bf16-cap12 / bf16-max / f32
            cfg12 = cfg.replace(vb=dataclasses.replace(cfg.vb, max_iters=12))
            specs = [("pallas_f32", cfg, "pallas"),
                     ("bf16_run_to_max", cfg, "pallas_bf16"),
                     ("bf16_cap12", cfg12, "pallas_bf16")]
            res = {}
            for name, c, f in specs + specs[::-1]:
                r = run_phase(args.partial_ms, N, f"[{name}] ", cfg_run=c,
                              fb_run=f)
                res.setdefault(name, []).append(r)
            for name, rs in res.items():
                print(f"engine {name}: best req/s "
                      f"{max(r[0] for r in rs):.1f}, best p95 "
                      f"{min(r[1] for r in rs):.0f}ms", flush=True)
        else:
            run_phase(args.partial_ms, N)
    finally:
        work.cleanup()
    print(json.dumps({"driver": "serving", "device": on, "clients": K,
                      "phases": phases, "failures": failures}), flush=True)
    if failures:
        log("torch_serving_bench: FAILED: " + "; ".join(failures))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
