"""Profiling helpers on torch.profiler: the counterparts of vbx_tpu's
jax.profiler `trace`, `annotate` and `parse_trace_executable_us`.

`trace()` is a no-op unless it is given a directory or VBX_TPU_TRACE_DIR is
set, so it can stay in production paths (cli/extract.py wraps the
extraction in it)."""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import socket
import time
from collections import defaultdict
from typing import Iterator, Optional

import torch

# chrome-trace categories of work that ran on a CUDA device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[Optional[str]]:
    """Capture a torch.profiler trace of the block (host ops, and CUDA
    kernels when a card is present) into `log_dir` as a gzipped chrome
    trace, `<host>_<pid>.<ns>.pt.trace.json.gz` (chrome://tracing,
    Perfetto, TensorBoard's profile plugin).

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
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
    prof.export_chrome_trace(
        os.path.join(log_dir, f"{name}.pt.trace.json.gz"))


def annotate(name: str):
    """Named region for the profiler timeline
    (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


def parse_trace_executable_us(log_dir: str) -> Optional[float]:
    """Total device time (microseconds) in the newest trace under
    `log_dir` that `trace()` wrote: the durations of the kernel, memcpy
    and memset events summed per device, the busiest device's total
    (work overlapped on two streams counts twice). None, never a made-up
    number, when there is no trace or it holds no device work (a CPU
    run)."""
    files = sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json*")),
                   key=os.path.getmtime)
    if not files:
        return None
    opener = gzip.open if files[-1].endswith(".gz") else open
    with opener(files[-1], "rt") as f:
        events = json.load(f)["traceEvents"]
    per_device = defaultdict(float)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            per_device[e.get("pid")] += float(e.get("dur", 0.0))
    return max(per_device.values()) if per_device else None
