"""Single-threaded BLAS guard for tiny per-recording host linalg.

The host model-prep eigendecompositions (the 128x128 PLDA
re-diagonalization, reference vbhmm.py:109-113, and the <=256x256
per-recording PCA of the dense Kaldi scoring path, diarization_lib.py:
59-93) are LAPACK calls on matrices small enough that OpenBLAS's
multi-threaded path is pure overhead: measured on the 4-core bench host,
`scipy.linalg.eigh(B, W)` at 128x128 costs 140-900 ms with the default
thread pool (spin-wait contention, load-dependent) and 3-4 ms pinned to
one thread — a ~200x pathology that dominated the warm end-to-end
ark->RTTM wall (0.9 s of a 1.2 s recording). The LARGE host dgemms (the
f64 AHC transform/cosine chain) keep the pool; only the tiny LAPACK
blocks are guarded.

threadpoolctl is the supported way to scope this per-call-site (env vars
like OPENBLAS_NUM_THREADS are process-global and would serialize the
big matmuls too); if it is absent the guard is a no-op and the code is
merely slow again, never wrong.
"""

from __future__ import annotations

import contextlib

try:
    from threadpoolctl import ThreadpoolController as _ThreadpoolController
except ImportError:  # pragma: no cover - baked into the target image
    _ThreadpoolController = None

# One process-wide controller, built lazily: ThreadpoolController() scans
# every loaded shared library for thread pools, which costs 100s of ms —
# per-call construction would cost more than the LAPACK it guards. The
# cached controller's limit() only flips the already-discovered pools'
# thread counts (microseconds). Pools loaded AFTER the first guard use
# are not governed — acceptable: numpy/scipy are imported long before
# any model prep runs.
_controller = None


def single_thread_blas():
    """Context manager: pin BLAS/LAPACK to one thread inside the block.

    Use around tiny (<=~256x256) eigh/inv/solve model-prep calls only —
    the throughput-relevant host dgemms want the full pool.
    """
    global _controller
    if _ThreadpoolController is None:
        return contextlib.nullcontext()
    if _controller is None:
        _controller = _ThreadpoolController()
    return _controller.limit(limits=1, user_api="blas")
