"""Agglomerative hierarchical clustering: first-party native NN-chain
linkage (C++ via ctypes) with a SciPy fallback, plus the flat-cut step.

A copy of vbx_tpu.clustering (same source, same build, same native-first
policy): the native chain numbers clusters differently from scipy, and the
label ids feed the VB init, so the port keeps the native code. This
replaces the reference's fastcluster dependency (vbhmm.py:33,139-146); the
O(n^2) sequential merge loop is host work and runs in native code.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_METHODS = {"single": 0, "complete": 1, "average": 2, "weighted": 3}

_lib = None
_lib_failed = False


def _load_native():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        from vbx_tpu_torch.clustering.native.build import build
        so_path = build()
        lib = ctypes.CDLL(so_path)
        lib.nn_chain_linkage_f64.restype = ctypes.c_int
        lib.nn_chain_linkage_f64.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double)]
        lib.nn_chain_linkage_f32.restype = ctypes.c_int
        lib.nn_chain_linkage_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double)]
        lib.nn_chain_linkage_dot_avg_f64.restype = ctypes.c_int
        lib.nn_chain_linkage_dot_avg_f64.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double)]
        lib.fcluster_distance.restype = ctypes.c_int
        lib.fcluster_distance.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int32)]
        lib.hist_moments_f64.restype = ctypes.c_int
        lib.hist_moments_f64.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
            ctypes.c_double, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double)]
        lib.linkage_set_threads.restype = None
        lib.linkage_set_threads.argtypes = [ctypes.c_int]
        lib.two_gmm_weighted_em.restype = ctypes.c_double
        lib.two_gmm_weighted_em.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int32]
        lib.squareform_condensed_f64.restype = None
        lib.squareform_condensed_f64.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double)]
        _lib = lib
    except Exception:
        _lib_failed = True
        _lib = None
    return _lib


def linkage(condensed: np.ndarray, method: str = "average",
            backend: Optional[str] = None) -> np.ndarray:
    """Hierarchical linkage over a condensed distance matrix.

    Returns a SciPy-compatible (n-1) x 4 linkage matrix Z. `backend` forces
    'native' or 'scipy'; default prefers native.

    NOTE: like fastcluster with preserve_input=False (the reference call,
    vbhmm.py:140-141), the native path works in a scratch copy; the input is
    never mutated.
    """
    condensed = np.ascontiguousarray(condensed)
    m = condensed.shape[0]
    # solve n*(n-1)/2 = m
    n = int(round((1 + np.sqrt(1 + 8 * m)) / 2))
    if n * (n - 1) // 2 != m:
        raise ValueError(f"invalid condensed matrix size {m}")
    if method not in _METHODS:
        raise ValueError(f"unsupported method {method!r}")

    lib = None if backend == "scipy" else _load_native()
    if lib is None:
        if backend == "native":
            raise RuntimeError("native linkage backend unavailable")
        import scipy.cluster.hierarchy as sch
        return sch.linkage(condensed.astype(np.float64), method=method)

    out = np.empty((n - 1, 4), dtype=np.float64)
    if condensed.dtype == np.float32:
        scratch = condensed.copy()
        rc = lib.nn_chain_linkage_f32(
            scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, _METHODS[method],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    else:
        scratch = condensed.astype(np.float64)
        rc = lib.nn_chain_linkage_f64(
            scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, _METHODS[method],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise RuntimeError(f"native linkage failed with code {rc}")
    return out


def linkage_dot_avg(xn: np.ndarray, backend: Optional[str] = None
                    ) -> np.ndarray:
    """Average linkage over the inner-product distance d(i,j) = -(x_i.x_j)
    WITHOUT materializing the condensed matrix: O(N.D) memory via the
    exact cluster-sums identity D(A,B) = -(S_A.S_B)/(|A||B|) (native
    nn_chain_linkage_dot_avg_f64). With l2-normalized rows this is the
    AHC chain's negated-cosine average linkage (reference
    vbhmm.py:135,139-141) — the long-recording answer to the 10 GB
    condensed buffer at N=50k (VERDICT r2 #3).

    backend='native' raises if the library is unavailable; the default
    falls back to the condensed path (materializes N^2 — fine at the
    small N where the library would be missing anyway)."""
    xn = np.ascontiguousarray(xn, dtype=np.float64)
    n, d = xn.shape
    if n < 2:
        return np.empty((0, 4), np.float64)
    lib = None if backend == "scipy" else _load_native()
    if lib is None:
        if backend == "native":
            raise RuntimeError("native linkage backend unavailable")
        scr = xn @ xn.T
        return linkage(squareform_condensed(scr, negate=True),
                       method="average", backend=backend)
    out = np.empty((n - 1, 4), dtype=np.float64)
    rc = lib.nn_chain_linkage_dot_avg_f64(
        xn.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, d,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise RuntimeError(f"native dot-avg linkage failed with code {rc}")
    return out


def fcluster_by_distance(Z: np.ndarray, threshold: float,
                         backend: Optional[str] = None) -> np.ndarray:
    """Flat clusters from a linkage matrix: all merges with dist <= threshold
    are applied (scipy fcluster criterion='distance' semantics). Returns
    0-based labels (the reference subtracts 1 from scipy's 1-based labels,
    vbhmm.py:145-146). The native backend numbers clusters by first
    appearance in leaf order; scipy numbers by dendrogram traversal — the
    partitions are identical (verified), only the arbitrary ids differ,
    which downstream (VB init, RTTM, DER) is permutation-invariant to."""
    Z = np.ascontiguousarray(Z, dtype=np.float64)
    n = Z.shape[0] + 1
    lib = None if backend == "scipy" else _load_native()
    if lib is None:
        if backend == "native":
            raise RuntimeError("native fcluster backend unavailable")
        import scipy.cluster.hierarchy as sch
        return sch.fcluster(Z, threshold, criterion="distance") - 1
    labels = np.empty(n, dtype=np.int32)
    rc = lib.fcluster_distance(
        Z.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n, float(threshold),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise RuntimeError(f"native fcluster failed with code {rc}")
    return labels


def set_native_threads(n: int) -> None:
    """Cap the native linkage OpenMP team size (process-global; no-op if
    the native library is unavailable). The corpus pipeline sets 1 while
    its init thread pool is active and restores the core count after."""
    lib = _load_native()
    if lib is not None:
        lib.linkage_set_threads(int(n))


def hist_moments(s: np.ndarray, lo: float, scale: float, n_bins: int,
                 cnt: np.ndarray, ssum: np.ndarray, s2sum: np.ndarray
                 ) -> bool:
    """Accumulate per-bin (count, sum, sum-of-squares) of `s` into the given
    f64 arrays in one native pass (bin = clip(int((v-lo)*scale), 0, n_bins-1)).
    Returns False if the native library is unavailable (caller falls back
    to numpy bincounts)."""
    lib = _load_native()
    if lib is None:
        return False
    s = np.ascontiguousarray(s, dtype=np.float64).reshape(-1)
    for name, a in (("cnt", cnt), ("ssum", ssum), ("s2sum", s2sum)):
        # explicit raise, not assert: the native call writes 8-byte doubles
        # through these buffers, so a mistyped array under `python -O`
        # (asserts stripped) would be silent heap corruption
        if a.dtype != np.float64 or not a.flags.c_contiguous:
            raise ValueError(
                f"hist_moments accumulator {name!r} must be C-contiguous "
                f"float64 (got dtype={a.dtype}, "
                f"contiguous={a.flags.c_contiguous})")
    lib.hist_moments_f64(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), s.size,
        ctypes.c_double(lo), ctypes.c_double(scale), n_bins,
        cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ssum.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        s2sum.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return True


def squareform_condensed(square: np.ndarray, negate: bool = False
                         ) -> np.ndarray:
    """Square symmetric matrix -> condensed upper-triangle vector (no checks,
    like the reference's squareform(..., checks=False) at vbhmm.py:139).

    Native one-pass copy when the library is available (GIL-free — the
    numpy per-row loop held the GIL through N small copies inside the
    serving init pool); numpy row-sliced fallback otherwise (still ~10x
    cheaper than triu_indices fancy indexing at N ~ 1e4)."""
    n = square.shape[0]
    lib = _load_native()
    if (lib is not None and square.dtype == np.float64
            and square.flags.c_contiguous):
        out = np.empty(n * (n - 1) // 2, dtype=np.float64)
        lib.squareform_condensed_f64(
            square.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, int(bool(negate)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out
    out = np.empty(n * (n - 1) // 2, dtype=square.dtype)
    o = 0
    for i in range(n - 1):
        m = n - i - 1
        if negate:
            np.negative(square[i, i + 1:], out=out[o:o + m])
        else:
            out[o:o + m] = square[i, i + 1:]
        o += m
    return out


def two_gmm_weighted_em_native(cnt: np.ndarray, ssum: np.ndarray,
                               s2sum: np.ndarray, sc: np.ndarray,
                               niters: int):
    """Native shared-variance 2-GMM EM over weighted score atoms; returns
    the equal-LLR threshold, or None if the native library is unavailable
    (caller falls back to the numpy reference implementation in
    ops/calibration._weighted_em_threshold — parity pinned by
    tests/test_clustering.py). GIL-free: the serving init pool's hottest
    pure-Python stage parallelizes across requests through this call."""
    lib = _load_native()
    if lib is None:
        return None
    arrs = [np.ascontiguousarray(a, dtype=np.float64).reshape(-1)
            for a in (cnt, ssum, s2sum, sc)]
    n = arrs[0].size
    if any(a.size != n for a in arrs):
        raise ValueError("cnt/ssum/s2sum/sc must have equal lengths")
    ptrs = [a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) for a in arrs]
    return float(lib.two_gmm_weighted_em(*ptrs, n, int(niters)))
