"""Two-Gaussian score calibration (shared-variance GMM EM), host paths.

Port of the NumPy routes of vbx_tpu.ops.calibration: finds the
utterance-specific AHC threshold by fitting a 2-component GMM with shared
variance to the N^2 pairwise similarity scores and returning the
equal-posterior crossing point (reference: diarization_lib.
twoGMMcalib_lin:13-31, 20 EM iterations). Everything runs in float64 on
the host: the threshold decides the AHC cluster count. vbx_tpu's device
sweeps (two_gmm_calib_cosine_device and its batched form) belong to the
device-AHC routes, which the port does not have yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _weighted_em_threshold(cnt, ssum, s2sum, sc, niters: int) -> float:
    """Shared-variance 2-GMM EM over weighted score atoms, returning the
    equal-LLR threshold (the fixed point of diarization_lib.
    twoGMMcalib_lin:13-31). Atoms are (count, sum, sum-of-squares,
    mean-score) — individual scores are atoms with cnt == 1, histogram bins
    carry their exact moments; both the exact and the binned public entry
    points run THIS loop so they cannot diverge.

    A GIL-free native twin (clustering.two_gmm_weighted_em_native, same
    init/updates/guards; agreement pinned at ~1e-12 by
    tests/test_clustering.py) runs when available — the EM is the serving
    init chain's hottest stage, and holding the GIL through 20 sigmoid
    sweeps serialized the whole init pool. This numpy loop remains the
    reference implementation and the fallback."""
    from vbx_tpu_torch.clustering import two_gmm_weighted_em_native
    thr = two_gmm_weighted_em_native(cnt, ssum, s2sum, sc, niters)
    if thr is not None:
        return thr

    total = cnt.sum()
    sum_s = ssum.sum()
    sum_s2 = s2sum.sum()
    mean = sum_s / total
    var = sum_s2 / total - mean ** 2
    if not var > 1e-12 * max(1.0, mean * mean):
        # degenerate scores (all identical up to rounding — e.g. a
        # one-cluster recording): the 2-GMM variance is zero modulo float
        # cancellation and the EM below divides by it (components collapse,
        # responsibilities saturate, counts hit 0/0); any threshold is
        # equivalent for such scores, so return the common value. The
        # reference would emit NaN here (diarization_lib.py:13-31 divides
        # by the shared variance unguarded). Real score sets sit many
        # orders above this cutoff (cosine-score var ~1e-2..1e-1).
        return float(mean)
    weights = np.array([0.5, 0.5])
    means = mean + np.sqrt(var) * np.array([-1.0, 1.0])
    for _ in range(niters):
        if not var > 1e-12 * max(1.0, mean * mean):
            # components merged mid-EM (near-degenerate scores): the
            # shared variance collapsed to ~0 and every division below
            # degenerates — same fallback as the up-front guard
            return float(mean)
        d = (means[1] - means[0]) / var
        c = (np.log(weights[1]) - np.log(weights[0])
             - 0.5 * (means[1] ** 2 - means[0] ** 2) / var)
        z = sc * d + c
        ez = np.exp(-np.abs(z))          # always in (0, 1]: no overflow
        g1 = np.where(z >= 0, 1.0 / (1.0 + ez), ez / (1.0 + ez))
        cnt1 = g1 @ cnt
        s1 = g1 @ ssum
        s2 = g1 @ s2sum
        cnt0, s0, q0 = total - cnt1, sum_s - s1, sum_s2 - s2
        weights = np.array([cnt0, cnt1]) / total
        means = np.array([s0 / cnt0, s1 / cnt1])
        second = np.array([q0 / cnt0, s2 / cnt1])
        var = (second - means ** 2) @ weights
    sel = np.array([1.0, -1.0])
    with np.errstate(all="ignore"):
        thr = float(-0.5
                    * ((np.log(weights ** 2 / var) - means ** 2 / var) @ sel)
                    / ((means / var) @ sel))
    # a collapse during the FINAL iteration bypasses the top-of-loop guard
    # (NaN/inf params reach the closed form); same fallback as above
    return thr if np.isfinite(thr) else float(mean)


def two_gmm_calib_lin_np(scores, niters: int = 20) -> float:
    """Host float64 two-GMM calibration over individual scores. The AHC init chain runs in float64 on the host by
    default because the calibration threshold feeds the linkage cut and
    therefore the cluster count: sub-1e-3 threshold shifts can change the
    number of AHC clusters and move the VB fixed point (reference parity:
    diarization_lib.twoGMMcalib_lin:13-31)."""
    s = np.asarray(scores, dtype=np.float64).reshape(-1)
    return _weighted_em_threshold(np.ones(s.size), s, s * s, s, niters)


def two_gmm_calib_from_moments(cnt, ssum, s2sum, niters: int = 20) -> float:
    """Binned 2-GMM calibration threshold from pre-accumulated per-bin
    moments (count, sum, sum-of-squares) — the streaming form of
    `two_gmm_calib_lin_binned` for callers that histogram scores
    block-by-block without materializing them (engine.ahc blocked cosine
    path). Empty bins are ignored; each bin's EM statistics use its exact
    moments, so the result is second-order-exact in the bin width."""
    cnt = np.asarray(cnt, np.float64)
    nz = cnt > 0
    cnt, ssum, s2sum = cnt[nz], np.asarray(ssum)[nz], np.asarray(s2sum)[nz]
    return _weighted_em_threshold(cnt, ssum, s2sum, ssum / cnt, niters)


def adaptive_bins(n: int, n_bins: Optional[int] = None) -> int:
    """Bin count for the histogram EM, scaled with the score count so the
    EM pass (niters x nonzero bins) stays well below the O(N^2) binning
    pass: ~n/64 bins, clamped to [2^12, 2^16]. Measured on the golden
    ES2005a scores (N=1025, n=N^2~1.05e6): the threshold error vs the
    exact EM is second-order in the bin width — 1.5e-10 at 2^16 bins,
    3.5e-9 at 2^14, 5.8e-8 at 2^12 — all 4-6 orders below the ~1e-4 scale
    of an AHC merge decision, while the serving-size EM drops 16 -> 2.7 ms
    from 2^17 to 2^14 bins. The 2^16 cap keeps the EM's working set (3
    moment arrays + temporaries) inside a core's L2: 2^17 bins measured
    6x SLOWER than 2^16 from cache spill alone (the previous rule's
    round-UP to 2^17 at ES2005a size violated exactly that). Every caller
    that histograms scores for `two_gmm_calib_from_moments` should use
    THIS rule so streamed and materialized paths bin comparably.

    `n_bins`, when given, OVERRIDES the 2^16 L2 cap (honored exactly as
    the new cap — a caller asking for 2^18 bins gets up to 2^18 and
    accepts the cache spill); None means the measured default."""
    cap = (1 << 16) if n_bins is None else n_bins
    target = max(n // 64, 1)
    return int(min(cap, max(1 << 12, 1 << (target - 1).bit_length())))


def two_gmm_calib_lin_binned(scores, niters: int = 20,
                             n_bins: Optional[int] = None) -> float:
    """Histogram-accelerated host f64 calibration for long recordings.

    The exact EM touches all N^2 scores every iteration — ~60 s of host
    time per AMI-length recording (N ~ 1e4). Binning the scores once into
    `n_bins` equal-width bins and running the SAME EM loop
    (_weighted_em_threshold) on (count, sum, sum-of-squares) per bin costs
    O(N^2 + niters * bins). With each bin carrying its exact moments the
    statistics error is second-order in the bin width: measured threshold
    agreement with the exact EM ~1e-9, far below the ~1e-4 scale that could
    move an AHC merge decision. Falls back to the exact EM for small inputs
    where it is already instant."""
    s = np.asarray(scores, dtype=np.float64).reshape(-1)
    n = s.size
    if n <= 1 << 18:
        # tiny inputs (N <~ 512 recordings): the exact EM is already ~ms
        return two_gmm_calib_lin_np(s, niters)

    lo, hi = s.min(), s.max()
    if hi <= lo:
        return float(lo)
    n_bins = adaptive_bins(n, n_bins)
    # chunked single pass: giant temporaries (idx int64, s*s) otherwise
    # dominate the runtime ~10x through allocator/memory-bandwidth churn.
    # The native single-pass accumulator (clustering.hist_moments — the
    # same routine the blocked cosine path streams through) does each chunk
    # in one C pass; the numpy fallback below bins identically (truncating
    # cast + clamp to the last bin).
    from vbx_tpu_torch.clustering import hist_moments

    scale = n_bins / (hi - lo)
    cnt = np.zeros(n_bins)
    ssum = np.zeros(n_bins)
    s2sum = np.zeros(n_bins)
    CH = 8_000_000
    for i in range(0, n, CH):
        chunk = s[i:i + CH]
        if hist_moments(chunk, lo, scale, n_bins, cnt, ssum, s2sum):
            continue
        idx = np.clip(((chunk - lo) * scale).astype(np.int64), 0, n_bins - 1)
        cnt += np.bincount(idx, minlength=n_bins)
        ssum += np.bincount(idx, weights=chunk, minlength=n_bins)
        s2sum += np.bincount(idx, weights=chunk * chunk, minlength=n_bins)
    nz = cnt > 0
    cnt, ssum, s2sum = cnt[nz], ssum[nz], s2sum[nz]
    return _weighted_em_threshold(cnt, ssum, s2sum, ssum / cnt, niters)
