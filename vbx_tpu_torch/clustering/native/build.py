"""Build the native linkage extension with g++ (no pybind11 — plain C ABI
consumed via ctypes). Idempotent: rebuilds only when the source is newer
than the shared object."""

from __future__ import annotations

import os
import subprocess
import sys
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "linkage.cpp")
SO = os.path.join(_HERE, "liblinkage.so")
HOST_TAG = SO + ".host"
_LOCK = threading.Lock()


def _host_tag() -> str:
    """Fingerprint of the CPU the .so was built for. -march=native makes
    the binary ISA-specific; a tree copied with preserved mtimes (rsync -a,
    docker COPY) to a different host would otherwise load a foreign .so
    and die with an uncatchable SIGILL at first call."""
    import hashlib
    import platform

    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:
        pass
    return (platform.machine() + ":"
            + hashlib.sha256(flags.encode()).hexdigest()[:16])


def build(force: bool = False) -> str:
    """Compile linkage.cpp -> liblinkage.so; returns the .so path."""
    with _LOCK:
        tag = _host_tag()
        if (not force and os.path.exists(SO)
                and os.path.getmtime(SO) >= os.path.getmtime(SRC)):
            try:
                with open(HOST_TAG) as f:
                    if f.read().strip() == tag:
                        return SO
            except OSError:
                pass   # no tag (pre-tag build or foreign tree): rebuild
        # build into a private file and rename: several test processes may
        # build at once, and none may load a half-written library
        tmp = f"{SO}.{os.getpid()}.tmp"
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++17", "-fopenmp",
            "-shared", "-fPIC", SRC, "-o", tmp,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            msg = getattr(e, "stderr", str(e))
            print(f"[vbx_tpu_torch] native linkage build failed: {msg}",
                  file=sys.stderr)
            raise
        os.replace(tmp, SO)
        with open(f"{HOST_TAG}.{os.getpid()}.tmp", "w") as f:
            f.write(tag + "\n")
        os.replace(f"{HOST_TAG}.{os.getpid()}.tmp", HOST_TAG)
        return SO


if __name__ == "__main__":
    print(build(force=True))
