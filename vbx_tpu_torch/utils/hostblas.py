"""Host thread pools: this module owns every limit the port puts on them.

`single_thread_blas` guards tiny per-recording host linalg. The host
model-prep eigendecompositions (the 128x128 PLDA re-diagonalization,
reference vbhmm.py:109-113, and the <=256x256 per-recording PCA of the
dense Kaldi scoring path, diarization_lib.py:59-93) are LAPACK calls on
matrices small enough that OpenBLAS's multi-threaded path is pure overhead:
measured on the 4-core bench host, `scipy.linalg.eigh(B, W)` at 128x128
costs 140-900 ms with the default thread pool (spin-wait contention,
load-dependent) and 3-4 ms pinned to one thread — a ~200x pathology that
dominated the warm end-to-end ark->RTTM wall (0.9 s of a 1.2 s recording).
The LARGE host dgemms (the f64 AHC transform/cosine chain) keep the pool;
only the tiny LAPACK blocks are guarded.

`host_pools` shares the cores among workers: the corpus pass's init pool
(engine.pipeline), the service's for its lifetime (serving) and a test
suite's processes (testing.host_threads).

threadpoolctl is the supported way to scope this per-call-site (env vars
like OPENBLAS_NUM_THREADS are process-global and would serialize the
big matmuls too), and only this module imports it; if it is absent the
BLAS limits are no-ops and the code is merely slow again, never wrong.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

try:
    from threadpoolctl import ThreadpoolController as _ThreadpoolController
except ImportError:  # pragma: no cover - baked into the target image
    _ThreadpoolController = None

# One process-wide controller, built lazily: ThreadpoolController() scans
# every loaded shared library for thread pools, which costs 100s of ms —
# per-call construction would cost more than the LAPACK it guards. The
# cached controller's limit() only flips the already-discovered pools'
# thread counts (microseconds). Pools loaded AFTER the scan are not
# governed, so scipy.linalg (which loads scipy's own OpenBLAS beside
# numpy's) is imported before it.
_controller = None
# the native team size the innermost host_pools block set (None: none
# open, the core count)
_native_threads: Optional[int] = None


def _blas_limit(n: int, user_api: Optional[str]):
    global _controller
    if _ThreadpoolController is None:
        return contextlib.nullcontext()
    if _controller is None:
        import scipy.linalg  # noqa: F401 — its BLAS must be in the scan
        _controller = _ThreadpoolController()
    return _controller.limit(limits=n, user_api=user_api)


def single_thread_blas():
    """Context manager: pin BLAS/LAPACK to one thread inside the block.

    Use around tiny (<=~256x256) eigh/inv/solve model-prep calls only —
    the throughput-relevant host dgemms want the full pool.
    """
    return _blas_limit(1, "blas")


@contextlib.contextmanager
def host_pools(n: int, user_api: Optional[str] = "blas"):
    """Cap the host's BLAS pools (user_api=None: every pool threadpoolctl
    finds, OpenMP's included) and the native linkage's OpenMP team
    (clustering.set_native_threads) at n threads inside the block. On exit
    the BLAS pools get back their limits and the native team the size an
    enclosing block set, or the core count."""
    global _native_threads
    from vbx_tpu_torch.clustering import set_native_threads

    outer, _native_threads = _native_threads, n
    set_native_threads(n)
    try:
        with _blas_limit(n, user_api):
            yield
    finally:
        _native_threads = outer
        set_native_threads(outer or os.cpu_count() or 1)
