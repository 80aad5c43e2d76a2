"""AHC initialization, host route (port of vbx_tpu.engine.ahc).

Pipeline parity with the reference diarization CLI (vbhmm.py:131-146):
similarity matrix -> utterance-specific calibration threshold -> condensed
negative-similarity matrix -> average linkage -> distance cut at
-(thr + threshold_bias), with the reference's nonnegative-shift ('adjust')
transformation of the linkage distances. Everything runs in float64 on the
host, through the same native linkage as vbx_tpu.

Long cosine recordings (N >= _BLOCKED_MIN_N) never materialize the N x N
matrix: the threshold comes from a streamed blocked histogram sweep and the
linkage from the O(N*D)-memory cluster-sums identity
(clustering.linkage_dot_avg).

vbx_tpu also has accelerator routes: compute_backend='device', and 'auto'
with an accelerator attached at N >= 6144 (device NN-chain walk) or
N >= 16384 (device calibration sweep). The port has no device AHC yet, so
those cases run this host chain; by the contract in tests/test_clustering.py
the device walk gives the same labels as the host chain.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np

from vbx_tpu_torch.clustering import (
    fcluster_by_distance, hist_moments, linkage, linkage_dot_avg,
    squareform_condensed)
from vbx_tpu_torch.ops.calibration import (
    two_gmm_calib_from_moments, two_gmm_calib_lin_binned)
from vbx_tpu_torch.ops.similarity import kaldi_plda_scoring_dense

# Blocked path cutoff: below this the full N x N materialization is cheap
# (the calibration over it is histogram-EM for N^2 > 2^18, exact below).
_BLOCKED_MIN_N = 4096
# Fixed-range [-1, 1] bins for the blocked path's streamed histogram (2^16:
# bin width 3e-5, threshold error ~1e-9; see calibration.adaptive_bins).
_COSINE_BINS = 1 << 16


def ahc_labels(
    x: np.ndarray,
    threshold_bias: float,
    similarity: str = "cosine",
    plda: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    target_energy: float = 1.0,
    pca_dim: Optional[int] = None,
    linkage_backend: Optional[str] = None,
    compute_backend: str = "auto",
) -> np.ndarray:
    """Cluster x-vectors; returns 0-based integer labels [N].

    x is the transformed (PLDA-space, length-normalized) x-vector matrix.
    `similarity` selects cosine (reference default, vbhmm.py:135) or the
    Kaldi-equivalent dense PLDA scoring (diarization_lib.py:59-93).
    `compute_backend` is validated like vbx_tpu's ('auto', 'host',
    'device'); every value runs the float64 host chain here (see the
    module docstring), and 'device' with PLDA scoring warns, as vbx_tpu's
    does. `linkage_backend` forces 'native' or 'scipy'.
    """
    if compute_backend not in ("auto", "host", "device"):
        raise ValueError(
            f"unknown compute_backend {compute_backend!r}; "
            f"expected 'auto', 'host' or 'device'")
    n = x.shape[0]
    if n == 1:
        return np.zeros(1, dtype=np.int32)

    condensed = thr = Z = None
    if similarity == "cosine":
        x64 = np.asarray(x, dtype=np.float64)
        xn = x64 / (np.sqrt((x64 * x64).sum(axis=1, keepdims=True)) + 1e-32)
        if n >= _BLOCKED_MIN_N:
            if linkage_backend != "scipy":
                try:
                    Z = linkage_dot_avg(xn, backend="native")
                except RuntimeError:   # native library unavailable
                    Z = None
                if Z is not None:
                    _, thr = _blocked_cosine_condensed_and_thr(
                        xn, want_condensed=False)
            if Z is None:
                condensed, thr = _blocked_cosine_condensed_and_thr(xn)
        else:
            scr_mx = xn @ xn.T
    elif similarity == "plda":
        if plda is None:
            raise ValueError("similarity='plda' requires a plda model")
        if compute_backend == "device":
            # the dense PLDA scorer has no device path: say so
            warnings.warn(
                "compute_backend='device' has no effect with "
                "similarity='plda'; scoring runs on host in f64",
                stacklevel=2)
        scr_mx = kaldi_plda_scoring_dense(
            plda, np.asarray(x), target_energy=target_energy, pca_dim=pca_dim)
    else:
        raise ValueError(f"unknown similarity {similarity!r}")

    if Z is None:
        if condensed is None:
            # utterance-specific calibration threshold over all N^2 scores
            # (vbhmm.py:137), in f64 on host for cut-threshold parity
            thr = two_gmm_calib_lin_binned(scr_mx)
            condensed = squareform_condensed(scr_mx, negate=True)
        Z = linkage(condensed, method="average", backend=linkage_backend)
    # shift distances nonnegative exactly as the reference does
    # (vbhmm.py:143-146) so the cut threshold transforms identically
    adjust = abs(Z[:, 2].min())
    Z = Z.copy()
    Z[:, 2] += adjust
    labels = fcluster_by_distance(Z, -(thr + threshold_bias) + adjust,
                                  backend=linkage_backend)
    return labels.astype(np.int32)


def _blocked_cosine_condensed_and_thr(
        xn: np.ndarray, blk: int = 512, want_condensed: bool = True
        ) -> Tuple[Optional[np.ndarray], float]:
    """Long-recording cosine AHC front half without materializing N x N:
    stream row blocks of xn @ xn.T, accumulating (a) the full-matrix score
    histogram moments for the binned 2-GMM calibration (reference parity:
    vbhmm.py:137 calibrates over ALL N^2 entries incl. the diagonal and
    both triangles) and (b) the negated upper triangle into the condensed
    distance vector. One pass over the N^2 scores, peak memory O(blk * N).
    want_condensed=False skips (b) — the linkage_dot_avg path needs only
    the threshold, so the O(N^2) buffer is never allocated.

    Bins are fixed to the cosine range [-1, 1] (scores are exactly bounded
    after l2 normalization); with exact per-bin moments the threshold
    differs from data-tight binning at ~1e-8, far below any merge-decision
    scale. Each block computes rows x columns[i0:] only (the matrix is
    symmetric); strict-upper moments are doubled and the diagonal counted
    once, reproducing the all-N^2-entries calibration."""
    N = xn.shape[0]
    cond = (np.empty(N * (N - 1) // 2, np.float64) if want_condensed
            else None)
    nb = _COSINE_BINS
    lo, hi = -1.0, 1.0
    scale = nb / (hi - lo)
    cnt = np.zeros(nb)
    ssum = np.zeros(nb)
    s2sum = np.zeros(nb)

    def hist(arr):
        nonlocal cnt, ssum, s2sum
        if not hist_moments(arr, lo, scale, nb, cnt, ssum, s2sum):
            flat = arr.reshape(-1)
            idx = np.minimum(((flat - lo) * scale).astype(np.int64), nb - 1)
            np.maximum(idx, 0, out=idx)
            cnt += np.bincount(idx, minlength=nb)
            ssum += np.bincount(idx, weights=flat, minlength=nb)
            s2sum += np.bincount(idx, weights=flat * flat, minlength=nb)

    diag = np.empty(N, np.float64)
    mask = None
    o = 0
    for i0 in range(0, N, blk):
        i1 = min(i0 + blk, N)
        b = i1 - i0
        xb = xn[i0:i1]
        St = xb @ xb.T                             # [b, b] diagonal block
        # [b, N - i0]: in-block columns then the strict-upper rectangle
        # (separate products, the same partition as vbx_tpu's sweep)
        R = (np.concatenate((St, xb @ xn[i1:].T), axis=1)
             if i1 < N else St)
        if mask is None or mask.shape != R.shape:
            mask = np.arange(R.shape[1])[None, :] > np.arange(b)[:, None]
        upper = R[mask]
        hist(upper)
        if want_condensed:
            np.negative(upper, out=cond[o:o + upper.size])
            o += upper.size
        diag[i0:i1] = np.diagonal(St)
    cnt *= 2.0
    ssum *= 2.0
    s2sum *= 2.0
    hist(diag)
    thr = two_gmm_calib_from_moments(cnt, ssum, s2sum)
    return cond, thr


def smooth_labels_to_gamma(labels: np.ndarray, smoothing: float,
                           n_speakers: Optional[int] = None) -> np.ndarray:
    """Hard labels -> soft responsibilities: softmax(onehot * smoothing)
    (reference: vbhmm.py:150-152)."""
    labels = np.asarray(labels)
    S = int(labels.max()) + 1 if n_speakers is None else n_speakers
    onehot = np.zeros((len(labels), S))
    onehot[np.arange(len(labels)), labels] = 1.0
    z = onehot * smoothing
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


def random_labels(n: int, n_speakers: int, seed: int = 0) -> np.ndarray:
    """Uniform random speaker assignment — the reference README's
    `random_<number>` init for long recordings where AHC is too slow
    (README.md:24)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_speakers, size=n).astype(np.int32)
