"""What every cell's run shares: finding the cell's files by name, the
card check, the traced window, the per-layer readers, and the result line.

A cell is an entry of BENCHMARK.json's `workloads`. Its configuration is
benchmark/configs/<config>.json, its traffic benchmark/traffic/<traffic>.json
(whose "driver" names the module of benchmark/drivers/ that runs it), the
comparison its outputs are held to (sample and limits)
benchmark/checks/<workload>.json, and each
per-layer metric that lists it (or lists no cells) is read by
benchmark/metrics/<metric>.py. A later cell, mix or metric is new files
and entries; no file here changes.
"""

import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Tuple

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "vbx_tpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Cell:
    """One workload of the manifest with its files, seed and window."""

    def __init__(self, manifest: dict, name: str, seed: int, seconds: float,
                 trace: bool, root: str = ROOT):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"have {sorted(cells)}")
        self.workload = cells[name]
        self.name = name
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.manifest = manifest
        bench = os.path.join(root, "benchmark")
        self.config = _json(os.path.join(
            bench, "configs", f"{self.workload['config']}.json"))
        self.traffic = _json(os.path.join(
            bench, "traffic", f"{self.workload['traffic']}.json"))
        self.check = _json(os.path.join(bench, "checks", f"{name}.json"))
        self.root = root

    def metrics(self, section: str) -> List[dict]:
        """The manifest's metrics of `section` that this cell reports."""
        return [m for m in self.manifest[section]
                if self.name in m.get("workloads", [self.name])]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def driver(cell: Cell):
    """The module of benchmark/drivers/ the cell's traffic names."""
    return importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")


def reader(metric: str, root: str = ROOT):
    """The `read(ctx)` function of benchmark/metrics/<metric>.py."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_count() -> int:
    """Cards this process can use; 0 where torch has no CUDA."""
    import torch

    if not torch.cuda.is_available():
        return 0
    return torch.cuda.device_count()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a JAX package or vbx_tpu,
    compared by whole name (vbx_tpu_torch is not vbx_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Traced:
    """torch.profiler over the window when `on`: device operations and the
    host's torch operations, read back from the exported chrome trace."""

    def __init__(self, on: bool, workdir: str):
        self.on = on
        self.path = os.path.join(workdir, "window_trace.json")
        self.device_ops: List[Tuple[float, float, str]] = []
        self.host_ops: List[Tuple[float, float, str]] = []
        self.t0_us = self.t1_us = None
        self._prof = None

    def __enter__(self):
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(self.path)
            self._read()
            os.remove(self.path)
        return False

    def mark(self, name: str):
        """A host span of the benchmark's own, in the trace when `on`."""
        import contextlib

        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def _read(self):
        with open(self.path) as f:
            evs = [e for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X"]
        for e in evs:
            s = float(e["ts"])
            iv = (s, s + float(e.get("dur", 0.0)), e["name"])
            if e.get("cat") in DEVICE_CATS:
                self.device_ops.append(iv)
            elif e.get("cat") in ("cpu_op", "user_annotation"):
                self.host_ops.append(iv)
        win = [h for h in self.host_ops if h[2] == "bench::window"]
        if win:
            self.t0_us, self.t1_us = win[0][0], win[0][1]

    def window_ops(self) -> List[Tuple[float, float, str]]:
        """Device operations clipped to the window span."""
        if self.t0_us is None:
            return list(self.device_ops)
        return [(max(s, self.t0_us), min(e, self.t1_us), n)
                for s, e, n in self.device_ops
                if e > self.t0_us and s < self.t1_us]


def breakdown(tr: Traced, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the innermost host operation running at each gap's
    start (or the benchmark span around it)."""
    from benchmark import yardstick

    ops = tr.window_ops()
    by = yardstick.by_name_seconds(ops)
    dev = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps = yardstick.idle_gaps([(s, e) for s, e, _ in ops],
                               tr.t0_us or 0.0, tr.t1_us or 0.0)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for g0, g1 in gaps:
        cover = [h for h in tr.host_ops if h[0] <= g0 < h[1]
                 and h[2] != "bench::window"]
        name = (max(cover, key=lambda h: h[0])[2] if cover
                else "host: no torch op")
        named.append([name[:120], (g1 - g0) / 1e6])
    return {"device_ops": [[n[:120], s] for n, s in dev],
            "idle_gaps": named}


def apply_host_env(cell: Cell) -> Dict[str, str]:
    """Set the configuration's `host_env` (environment variables of the
    deployment's host, such as its BLAS threads) in this process, before
    numpy or torch is imported; returns them."""
    env = {k: str(v) for k, v in cell.config.get("host_env", {}).items()
           if not k.startswith("_")}
    os.environ.update(env)
    return env


def reset_peak(on_card: bool) -> None:
    """Start the card's memory peak afresh as the window opens."""
    if on_card:
        import torch

        torch.cuda.reset_peak_memory_stats(0)


def device_info(on_card: bool) -> dict:
    """The result's `device`, read as the window closes, before the
    reference runs (a CPU rehearsal names the CPU and no peak)."""
    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def add_trace(result: dict, tr: Traced, window_s: float) -> None:
    """A traced run's device busy seconds (the union of the window's
    device intervals), window length and breakdown."""
    from benchmark import yardstick

    result["device"]["busy_s"] = yardstick.union_seconds(
        (s, e) for s, e, _ in tr.window_ops()) / 1e6
    result["device"]["window_s"] = window_s
    result["breakdown"] = breakdown(tr)


def emit(result: dict, checks: List[Tuple[str, float, float]]) -> None:
    """Each compared number beside its limit, on standard error and under
    the result line's last key, then the result line itself."""
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    print(json.dumps(result), flush=True)


class Clock:
    """Seconds since the process started its set-up."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self) -> float:
        return time.perf_counter() - self.t0


def read_layer_metrics(cell: Cell, ctx: dict) -> Dict[str, dict]:
    """Every per-layer metric of the cell whose reader finds something."""
    out = {}
    for m in cell.metrics("per_layer"):
        v = reader(m["name"], cell.root)(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def within(checks: List[Tuple[str, float, float]]) -> bool:
    """Every compared number at or under its limit (NaN fails)."""
    return all(v <= lim for _, v, lim in checks)


def sample(rng_seed: int, population: list, k: int) -> list:
    """k members of `population` drawn from the seed, in population order."""
    import numpy as np

    if k >= len(population):
        return list(population)
    idx = np.random.default_rng([rng_seed, 0xC4EC]).choice(
        len(population), size=k, replace=False)
    return [population[i] for i in sorted(idx)]

