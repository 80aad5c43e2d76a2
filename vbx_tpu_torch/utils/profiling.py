"""Profiling helpers on torch.profiler: the counterparts of vbx_tpu's
jax.profiler `trace` and `annotate`, and `idle_by_span`, which reads a
trace back.

`trace()` is a no-op unless it is given a directory or VBX_TPU_TRACE_DIR is
set, so it can stay in production paths (cli/extract.py, cli/diarize.py,
cli/run_corpus.py and cli/serve.py wrap their run in it). `annotate` is the
program's one span: a `record_function` range on the profiler's clock,
which also adds its host seconds to a stage log when given one.

    python -m vbx_tpu_torch.utils.profiling <dir>

prints `idle_by_span` of the newest trace under <dir> as one JSON line."""

from __future__ import annotations

import bisect
import contextlib
import glob
import gzip
import json
import os
import socket
import sys
import time
from typing import Dict, Iterator, List, MutableMapping, Optional, Tuple

import torch

# chrome-trace categories of work that ran on a CUDA device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the range trace() opens on its own thread around the block: the trace's
# window, and the thread whose spans name the device's idle time
ROOT_SPAN = "profiling.trace"
SPAN_PREFIX = "vbx."
OUTSIDE = "outside any span"


def _experimental_config():
    """Kineto's config that records every thread's ranges (worker pools'
    spans too), where the installed torch has the option; else None."""
    try:
        return torch.profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[Optional[str]]:
    """Capture a torch.profiler trace of the block (host ops and spans of
    every thread, and CUDA kernels when a card is present) into `log_dir`
    as a gzipped chrome trace, `<host>_<pid>.<ns>.pt.trace.json.gz`
    (chrome://tracing, Perfetto, TensorBoard's profile plugin,
    `idle_by_span`).

    With log_dir None and VBX_TPU_TRACE_DIR unset, a no-op. Yields the
    directory the trace is written to."""
    log_dir = log_dir or os.environ.get("VBX_TPU_TRACE_DIR")
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    cfg = _experimental_config()
    kw = {} if cfg is None else {"experimental_config": cfg}
    with torch.profiler.profile(activities=activities, **kw) as prof:
        with torch.profiler.record_function(ROOT_SPAN):
            yield log_dir
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
    prof.export_chrome_trace(
        os.path.join(log_dir, f"{name}.pt.trace.json.gz"))


@contextlib.contextmanager
def annotate(name: str, log: Optional[MutableMapping[str, float]] = None,
             key: Optional[str] = None) -> Iterator[None]:
    """A named span: a torch.profiler `record_function` range, which lands
    in any active trace on the clock of the card's kernels and copies.
    With `log` a dict, the span's host seconds (perf_counter) are also
    added to `log[key]`, so repeated spans accumulate. Adds no device
    synchronization."""
    t = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if log is not None:
            log[key] = log.get(key, 0.0) + time.perf_counter() - t


def _newest_trace(log_dir: str) -> Optional[str]:
    files = sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json*")),
                   key=os.path.getmtime)
    return files[-1] if files else None


def _union(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    """The union of (start, end) intervals as disjoint, sorted ones."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_by_span(log_dir: str) -> Optional[dict]:
    """The device's busy and idle seconds in the newest trace under
    `log_dir` that `trace()` wrote, over its window (the range trace()
    opened): `busy_s`, the union of the device's kernel, copy and set
    intervals (work on two streams at once counts once); `idle_s`, the
    rest of the window grouped by the innermost `vbx.` span open at the
    time on the thread that opened the trace, with "outside any span" as
    its own key, largest first. None when there is no trace, or it holds
    no window."""
    path = _newest_trace(log_dir)
    if path is None:
        return None
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    roots = [e for e in events if e.get("name") == ROOT_SPAN
             and e.get("cat") == "user_annotation"]
    if not roots:
        return None
    root = roots[0]
    lo = float(root["ts"])
    hi = lo + float(root.get("dur", 0.0))
    busy = _union([(max(s, lo), min(e, hi)) for s, e in (
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        for e in events if e.get("cat") in DEVICE_CATEGORIES)
        if e > lo and s < hi])
    starts = [s for s, _ in busy]
    covered = [0.0]
    for s, e in busy:
        covered.append(covered[-1] + e - s)

    def busy_in(a: float, b: float) -> float:
        """Busy microseconds inside [a, b]."""
        i = bisect.bisect_right(starts, a) - 1
        j = bisect.bisect_left(starts, b)
        total = covered[j] - covered[max(i, 0)]
        if i >= 0:       # the interval that starts at or before a
            total -= min(busy[i][1], a) - busy[i][0]
        if j > 0:        # the last interval that starts before b
            total -= max(busy[j - 1][1] - b, 0.0)
        return total

    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
              e["name"]) for e in events
             if e.get("cat") == "user_annotation"
             and e.get("tid") == root.get("tid")
             and e["name"].startswith(SPAN_PREFIX)]
    points = sorted({lo, hi} | {min(max(t, lo), hi)
                                for s, e, _ in spans for t in (s, e)})
    idle: Dict[str, float] = {}
    for a, b in zip(points, points[1:]):
        mid = 0.5 * (a + b)
        open_ = [(s, -e, n) for s, e, n in spans if s <= mid < e]
        name = max(open_)[2] if open_ else OUTSIDE
        idle[name] = idle.get(name, 0.0) + (b - a - busy_in(a, b)) / 1e6
    return {"trace": os.path.basename(path), "window_s": (hi - lo) / 1e6,
            "busy_s": covered[-1] / 1e6,
            "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1]))}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print("usage: python -m vbx_tpu_torch.utils.profiling <trace dir>",
              file=sys.stderr)
        return 2
    res = idle_by_span(args[0])
    if res is None:
        print(f"no trace written by profiling.trace() under {args[0]}",
              file=sys.stderr)
        return 1
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
