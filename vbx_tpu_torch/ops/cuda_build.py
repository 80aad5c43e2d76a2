"""Build and load the port's hand-written CUDA kernels (vbx_tpu_torch/csrc).

Each `csrc/<name>.cu` exposes a plain C interface and is compiled with nvcc
into `build/vbx_tpu_torch/lib<name>.so` beside the package (a git-ignored
directory), then loaded with ctypes. No PyTorch headers are involved, so a
build takes seconds. Sources are built at first use, or all together (one
nvcc process per source, started at once) through `build()`. Nothing here
runs at import time: the CPU tests import every module of the port on
machines without nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "vbx_tpu_torch")
# sm_90a: Hopper with its architecture-specific features. No
# --use_fast_math: it flushes denormals and approximates division, and the
# kernels' 1e-37 normalizer floor sits just above float32's normal range.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, str]:
    """{kernel name: path of its .cu source}."""
    return {f[:-3]: os.path.join(CSRC_DIR, f)
            for f in sorted(os.listdir(CSRC_DIR)) if f.endswith(".cu")}


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def _stale(name: str, src: str) -> bool:
    so = library_path(name)
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(
        src)


def build(names: Optional[Iterable[str]] = None,
          force: bool = False) -> Dict[str, str]:
    """Compile the named kernels (default: every csrc source), one nvcc
    process per source, all started together. Returns {name: nvcc's report}
    (ptxas registers/spills) for each source compiled; up-to-date libraries
    are skipped. Raises RuntimeError naming the source that failed."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    with _LOCK:
        todo = [n for n in names if force or _stale(n, srcs[n])]
        if not todo:
            return {}
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = f"{library_path(n)}.{os.getpid()}.tmp"
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, srcs[n]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        reports, failed = {}, {}
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed[n] = out
                continue
            # rename into place: a concurrent process never loads a
            # half-written library
            os.replace(tmp, library_path(n))
            reports[n] = out
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(
                f"{n}:\n{out}" for n, out in failed.items()))
        return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if missing or older
    than its source."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _LIBS[name] = lib
    return lib
