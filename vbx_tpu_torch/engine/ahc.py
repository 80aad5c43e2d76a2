"""AHC initialization (port of vbx_tpu.engine.ahc).

Pipeline parity with the reference diarization CLI (vbhmm.py:131-146):
similarity matrix -> utterance-specific calibration threshold -> condensed
negative-similarity matrix -> average linkage -> distance cut at
-(thr + threshold_bias), with the reference's nonnegative-shift ('adjust')
transformation of the linkage distances.

Routes, as vbx_tpu's, with `device` in the place of jax.default_backend():
- 'host' (and every short recording under 'auto'): float64 on the host,
  through the same native linkage as vbx_tpu. Long cosine recordings
  (N >= _BLOCKED_MIN_N) never materialize the N x N matrix: the threshold
  comes from a streamed blocked histogram sweep and the linkage from the
  O(N*D)-memory cluster-sums identity (clustering.linkage_dot_avg).
- 'auto' on a CUDA device: from _DEVICE_LINKAGE_MIN_N the NN-chain walk
  runs on the card (clustering.device, csrc/nn_chain.cu) with the host
  threshold; from _DEVICE_CALIB_MIN_N the calibration sweep runs there too
  ('device' below).
- 'device', N >= _BLOCKED_MIN_N: the streamed calibration sweep on the
  device (ops.calibration.two_gmm_calib_cosine_device) and, on a CUDA
  device, the walk on the card; elsewhere the native host chain.
- 'device', N < _BLOCKED_MIN_N: cosine scores on the device in float32,
  calibrated in float64 on the host.
- precomputed_Z (the corpus pre-stage's batched walk): the cut is made on
  it, with precomputed_thr if given, else the threshold routed as 'auto'.

Fallback, narrowed on purpose: vbx_tpu catches every exception of its
device walk and sweep and warns. The port falls back to the host float64
chain, with vbx_tpu's warning, only when the walk's reducibility guard
trips (clustering.device.ReducibilityError: a near-tie that broke the
chain's invariant). A kernel that fails to build or launch, a CUDA error or an
out-of-memory error propagates: a route that dropped to the host on its own
would hide the device.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np

from vbx_tpu_torch.clustering import (
    fcluster_by_distance, hist_moments, linkage, linkage_dot_avg,
    squareform_condensed)
from vbx_tpu_torch.device import DeviceLike, resolve_device
from vbx_tpu_torch.ops.calibration import (
    two_gmm_calib_from_moments, two_gmm_calib_lin_binned)
from vbx_tpu_torch.ops.similarity import kaldi_plda_scoring_dense

# Blocked path cutoff: below this the full N x N materialization is cheap
# (the calibration over it is histogram-EM for N^2 > 2^18, exact below).
_BLOCKED_MIN_N = 4096
# 'auto' device-calibration cutoff, vbx_tpu's (measured on its TPU host).
_DEVICE_CALIB_MIN_N = 16384
# 'auto' device-linkage cutoff, vbx_tpu's (measured on its TPU host).
_DEVICE_LINKAGE_MIN_N = 6144
# Fixed-range [-1, 1] bins for the blocked path's streamed histogram (2^16:
# bin width 3e-5, threshold error ~1e-9; see calibration.adaptive_bins).
_COSINE_BINS = 1 << 16


def _on_cuda(device: DeviceLike) -> bool:
    """Whether the accelerator routes apply: the resolved device is a CUDA
    card (the counterpart of vbx_tpu's jax.default_backend() != 'cpu')."""
    return resolve_device(device).type == "cuda"


def _normalized(x: np.ndarray) -> np.ndarray:
    x64 = np.asarray(x, dtype=np.float64)
    return x64 / (np.sqrt((x64 * x64).sum(axis=1, keepdims=True)) + 1e-32)


def _try_device_linkage(xn: np.ndarray, device: DeviceLike):
    """The NN-chain walk on the card, or None when the device is not CUDA
    or the walk's reducibility guard trips (the caller then runs the host
    float64 chain; `fallbacks` counts those). One definition keeps the
    long-N 'device' branch and the mid-N 'auto' branch in step. Any other
    failure propagates."""
    if not _on_cuda(device):
        return None
    from vbx_tpu_torch.clustering import device as cdev
    try:
        return cdev.linkage_dot_avg_device(xn, device=device)
    except cdev.ReducibilityError as exc:
        _try_device_linkage.fallbacks += 1
        warnings.warn(
            f"device linkage failed ({exc!r}); falling back to the host "
            f"NN-chain", stacklevel=3)
        return None


_try_device_linkage.fallbacks = 0   # guard trips since the caller reset it


def ahc_labels(
    x: np.ndarray,
    threshold_bias: float,
    similarity: str = "cosine",
    plda: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    target_energy: float = 1.0,
    pca_dim: Optional[int] = None,
    linkage_backend: Optional[str] = None,
    compute_backend: str = "auto",
    precomputed_Z: Optional[np.ndarray] = None,
    precomputed_thr: Optional[float] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Cluster x-vectors; returns 0-based integer labels [N].

    x is the transformed (PLDA-space, length-normalized) x-vector matrix.
    `similarity` selects cosine (reference default, vbhmm.py:135) or the
    Kaldi-equivalent dense PLDA scoring (diarization_lib.py:59-93).
    `compute_backend` is 'auto', 'host' or 'device' (module docstring);
    `device` ('cuda' unless the caller passes another) is resolved only
    where a route needs it, so 'host' and short 'auto' recordings never
    touch it. `linkage_backend` forces 'native' or 'scipy'.
    """
    if compute_backend not in ("auto", "host", "device"):
        raise ValueError(
            f"unknown compute_backend {compute_backend!r}; "
            f"expected 'auto', 'host' or 'device'")
    n = x.shape[0]
    if n == 1:
        return np.zeros(1, dtype=np.int32)

    condensed = thr = Z = None
    requested_backend = compute_backend
    if (precomputed_Z is not None and similarity == "cosine"
            and n >= _BLOCKED_MIN_N):
        # corpus pre-stage (engine.pipeline): this recording's walk ran in
        # one batched device call; its threshold too, when given
        if precomputed_thr is not None:
            thr = float(precomputed_thr)
        else:
            xn = _normalized(x)
            if n >= _DEVICE_CALIB_MIN_N and _on_cuda(device):
                from vbx_tpu_torch.ops.calibration import (
                    two_gmm_calib_cosine_device)
                thr = two_gmm_calib_cosine_device(xn, device=device)
            else:
                _, thr = _blocked_cosine_condensed_and_thr(
                    xn, want_condensed=False)
        Z = precomputed_Z
    elif similarity == "cosine":
        long_n = n >= _BLOCKED_MIN_N
        if compute_backend == "auto":
            compute_backend = ("device" if n >= _DEVICE_CALIB_MIN_N
                               and _on_cuda(device) else "host")
        if compute_backend == "device" and long_n:
            # the calibration sweep streams through the device (only the
            # block sums cross to the host); the walk runs on the card
            xn = _normalized(x)
            from vbx_tpu_torch.ops.calibration import (
                two_gmm_calib_cosine_device)
            thr = two_gmm_calib_cosine_device(xn, device=device)
            if linkage_backend != "scipy":
                Z = _try_device_linkage(xn, device)
                if Z is None:
                    try:
                        Z = linkage_dot_avg(xn, backend="native")
                    except RuntimeError as exc:
                        warnings.warn(
                            f"native linkage unavailable ({exc}); device "
                            f"threshold + condensed host linkage",
                            stacklevel=2)
            if Z is None:
                condensed, _ = _blocked_cosine_condensed_and_thr(
                    xn, want_thr=False)
        if compute_backend == "host":
            xn = _normalized(x)
            if long_n:
                if linkage_backend != "scipy":
                    if (requested_backend == "auto"
                            and n >= _DEVICE_LINKAGE_MIN_N):
                        # 'auto' mid-N band [6144, 16384): the threshold
                        # stays on the host, the walk goes to the card
                        Z = _try_device_linkage(xn, device)
                    if Z is None:
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
        elif compute_backend == "device" and not long_n:
            # float32 scores on the device, float64 calibration on the host
            import torch

            from vbx_tpu_torch.device import full_fp32_matmuls
            from vbx_tpu_torch.ops.similarity import cos_similarity
            xt = torch.as_tensor(np.asarray(x, np.float32),
                                 device=resolve_device(device))
            with full_fp32_matmuls():
                scr_mx = cos_similarity(xt).cpu().numpy().astype(np.float64)
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
        xn: np.ndarray, blk: int = 512, want_condensed: bool = True,
        want_thr: bool = True
        ) -> Tuple[Optional[np.ndarray], Optional[float]]:
    """Long-recording cosine AHC front half without materializing N x N:
    stream row blocks of xn @ xn.T, accumulating (a) the full-matrix score
    histogram moments for the binned 2-GMM calibration (reference parity:
    vbhmm.py:137 calibrates over ALL N^2 entries incl. the diagonal and
    both triangles) and (b) the negated upper triangle into the condensed
    distance vector. One pass over the N^2 scores, peak memory O(blk * N).
    want_condensed=False skips (b) — the linkage_dot_avg path needs only
    the threshold, so the O(N^2) buffer is never allocated. want_thr=False
    skips (a): the device route already holds the threshold.

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
        if want_thr:
            hist(upper)
        if want_condensed:
            np.negative(upper, out=cond[o:o + upper.size])
            o += upper.size
        diag[i0:i1] = np.diagonal(St)
    if not want_thr:
        return cond, None
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
