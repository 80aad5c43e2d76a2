"""Two-Gaussian score calibration (shared-variance GMM EM).

Port of vbx_tpu.ops.calibration: finds the utterance-specific AHC threshold
by fitting a 2-component GMM with shared variance to the N^2 pairwise
similarity scores and returning the equal-posterior crossing point
(reference: diarization_lib.twoGMMcalib_lin:13-31, 20 EM iterations).

Host routes (NumPy, float64): the exact EM, the binned EM over per-bin
moments, and the moments' streaming form. The threshold decides the AHC
cluster count, so the init chain runs them by default.

Device routes (torch, on the scores' or the x-vectors' device):
- two_gmm_calib_lin / two_gmm_calib_with_llrs: the 20-iteration EM over a
  score tensor at its dtype (vbx_tpu's _em_params / _threshold_from);
- two_gmm_calib_cosine_device and its _batched form: one pass over the
  implicit N x N cosine matrix per EM iteration, [blk, Np] tiles of
  xn @ xn.T (a float32 product with TF32 off, the counterpart of
  Precision.HIGHEST) reduced to per-block partial sums of
  (g1, g1 s, g1 s^2, s, s^2); the host sums the blocks and runs the EM
  updates in float64. The sigmoid and the five sums are plain torch ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vbx_tpu_torch.device import DeviceLike, full_fp32_matmuls, resolve_device


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


# -- device routes ---------------------------------------------------------


def _em_params(s: torch.Tensor, niters: int, init_state=None):
    """The shared-variance 2-GMM EM on flattened scores at their dtype;
    returns the final (weights [2], means [2], var). `init_state` resumes
    from given (weights, means, var) instead of the data init."""
    n = s.shape[0]
    sum_s = s.sum()
    sum_s2 = (s * s).sum()
    if init_state is None:
        weights = torch.tensor([0.5, 0.5], dtype=s.dtype, device=s.device)
        sign = torch.tensor([-1.0, 1.0], dtype=s.dtype, device=s.device)
        means = s.mean() + s.std(correction=0) * sign
        var = s.var(correction=0)
    else:
        weights, means, var = init_state
    for _ in range(niters):
        logw = torch.log(weights)
        d = (means[1] - means[0]) / var
        c = (logw[1] - logw[0]) - 0.5 * (means[1] ** 2 - means[0] ** 2) / var
        g1 = torch.sigmoid(s * d + c)
        cnt1 = g1.sum()
        s1 = torch.dot(g1, s)
        s2 = torch.dot(g1, s * s)
        cnt0 = n - cnt1
        cnts = torch.stack([cnt0, cnt1])
        weights = cnts / (cnt0 + cnt1)
        means = torch.stack([(sum_s - s1) / cnt0, s1 / cnt1])
        second = torch.stack([(sum_s2 - s2) / cnt0, s2 / cnt1])
        var = torch.dot(second - means ** 2, weights)
    return weights, means, var


def _threshold_from(weights: torch.Tensor, means: torch.Tensor,
                    var: torch.Tensor) -> torch.Tensor:
    """Closed-form equal-LLR crossing of the fitted components."""
    sel = torch.tensor([1.0, -1.0], dtype=means.dtype, device=means.device)
    return (-0.5 * torch.dot(torch.log(weights ** 2 / var) - means ** 2 / var,
                             sel)
            / torch.dot(means / var, sel))


def two_gmm_calib_lin(scores: torch.Tensor, niters: int = 20
                      ) -> torch.Tensor:
    """Calibration threshold (a 0-d tensor on the scores' device) of the
    flattened scores, at their dtype: the reference fixed point
    (diarization_lib.twoGMMcalib_lin:13-31)."""
    with full_fp32_matmuls():
        return _threshold_from(*_em_params(scores.reshape(-1), niters))


def two_gmm_calib_with_llrs(scores: torch.Tensor, niters: int = 20
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threshold plus linearly calibrated log-odds-ratio scores, the
    reference's semantics: the llrs come from the parameters ENTERING the
    final EM iteration (the reference computes lls before updating), the
    threshold and the target-component ordering (argmax/argmin of the
    means) from the post-loop parameters."""
    if niters < 1:
        raise ValueError("niters must be >= 1")
    s = scores.reshape(-1)
    with full_fp32_matmuls():
        prev = _em_params(s, niters - 1)
        weights, means, var = _em_params(s, 1, init_state=prev)
        threshold = _threshold_from(weights, means, var)
    pw, pm, pv = prev
    lls = (torch.log(pw) - 0.5 * torch.log(pv)
           - 0.5 * (s[:, None] - pm) ** 2 / pv)
    llrs = lls[:, int(torch.argmax(means))] - lls[:, int(torch.argmin(means))]
    return threshold, llrs


# elements of one sweep tile ([lanes, rows, Np] float32 scores), 256 MB:
# several row blocks per product keeps the launches of a pass few
_TILE_ELEMS = 1 << 26


def _cosine_sweep(x: torch.Tensor, ns: torch.Tensor, d: torch.Tensor,
                  c: torch.Tensor, blk: int) -> torch.Tensor:
    """One pass over each lane's implicit Np x Np cosine matrix
    (x [M, Np, D] float32 on the device, lane m's first ns[m] rows valid):
    per-block partial sums [M, Np // blk, 5] of (g1, g1 s, g1 s^2, s, s^2)
    over valid rows and columns, g1 = sigmoid(s d_m + c_m). d = c = 0
    gives the init pass (g1 = 1/2)."""
    M, Np, _ = x.shape
    nb = Np // blk
    per = max(1, min(nb, _TILE_ELEMS // (M * blk * Np)))
    cols = torch.arange(Np, device=x.device)
    col_ok = cols[None, :] < ns[:, None]                     # [M, Np]
    xt = x.transpose(1, 2)
    dd = d[:, None, None]
    cc = c[:, None, None]
    parts = []
    for b0 in range(0, nb, per):
        b1 = min(nb, b0 + per)
        r0, r1 = b0 * blk, b1 * blk
        s = torch.bmm(x[:, r0:r1], xt)                       # [M, R, Np]
        w = ((cols[r0:r1][None, :, None] < ns[:, None, None])
             & col_ok[:, None, :]).to(s.dtype)
        g1 = torch.sigmoid(s * dd + cc) * w
        sw = s * w
        g1s = g1 * s
        shape = (M, b1 - b0, -1)
        parts.append(torch.stack([
            g1.reshape(shape).sum(-1), g1s.reshape(shape).sum(-1),
            (g1s * s).reshape(shape).sum(-1), sw.reshape(shape).sum(-1),
            (sw * s).reshape(shape).sum(-1)], dim=-1))
    return torch.cat(parts, dim=1)


def _padded_rows(n: int, blk: int) -> int:
    """A sweep's row extent for n rows: n rounded up to a multiple of blk
    (at least one block)."""
    return max(blk, -(-n // blk) * blk)


def _sweep_lanes(xns, n_pad: int, blk: int, device: DeviceLike):
    """(full_pass(d, c) -> [M, 5] float64 host sums, ns) for the lanes'
    xn padded with zero rows to n_pad on the device."""
    dev = resolve_device(device)
    m = len(xns)
    ns = np.array([x.shape[0] for x in xns], np.int64)
    x_pad = np.zeros((m, n_pad, xns[0].shape[1]), np.float32)
    for i, x in enumerate(xns):
        x_pad[i, :x.shape[0]] = np.asarray(x, np.float32)
    xd = torch.from_numpy(x_pad).to(dev)
    nsd = torch.from_numpy(ns).to(dev)

    def full_pass(d, c):
        dt = torch.as_tensor(np.asarray(d, np.float32), device=dev)
        ct = torch.as_tensor(np.asarray(c, np.float32), device=dev)
        with full_fp32_matmuls():
            parts = _cosine_sweep(xd, nsd, dt, ct, blk)
        return parts.cpu().numpy().astype(np.float64).sum(axis=1)

    return full_pass, ns


def two_gmm_calib_cosine_device(xn, niters: int = 20, blk: int = 512,
                                device: DeviceLike = None) -> float:
    """Streamed calibration threshold for the long-recording cosine AHC
    front half: the N x N score matrix passes through the device one tile
    at a time and only the per-block partial sums cross to the host, where
    the EM updates run in float64 with _weighted_em_threshold's
    degenerate-variance guards and non-finite fallback. Rows are padded
    with zeros to a multiple of blk (vbx_tpu pads to a power of two, which
    bought XLA one program a size bucket; eager products compile nothing,
    and the padded rows and columns are masked out of every sum).

    xn: [N, D] L2-NORMALIZED x-vectors. Every entry of the full symmetric
    N^2 matrix, diagonal included, is counted (twoGMMcalib_lin's all-N^2
    semantics, vbhmm.py:137)."""
    xn = np.asarray(xn)
    n = xn.shape[0]
    full_pass, _ = _sweep_lanes([xn], _padded_rows(n, blk), blk, device)

    def one(d, c):
        return full_pass([d], [c])[0]

    total = float(n) * float(n)
    _, _, _, sum_s, sum_s2 = one(0.0, 0.0)
    mean = sum_s / total
    var = sum_s2 / total - mean ** 2
    if not var > 1e-12 * max(1.0, mean * mean):
        return float(mean)             # degenerate scores (see host twin)
    weights = np.array([0.5, 0.5])
    means = mean + np.sqrt(var) * np.array([-1.0, 1.0])
    for _ in range(niters):
        if not var > 1e-12 * max(1.0, mean * mean):
            return float(mean)
        d = (means[1] - means[0]) / var
        c = (np.log(weights[1]) - np.log(weights[0])
             - 0.5 * (means[1] ** 2 - means[0] ** 2) / var)
        cnt1, s1, s2, _, _ = one(d, c)
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
    return thr if np.isfinite(thr) else float(mean)


def two_gmm_calib_cosine_device_batched(xns, niters: int = 20,
                                        blk: int = 512,
                                        device: DeviceLike = None
                                        ) -> np.ndarray:
    """Batched two_gmm_calib_cosine_device: one threshold per recording
    (float64 [M]), every lane swept by one pass per EM iteration. Lanes are
    padded with zeros to the group's longest, rounded up to a multiple of
    blk (vbx_tpu rounds to a 2048-row quantum). Per-lane semantics mirror
    the single form: the same init and updates, a lane whose variance
    degenerates freezes (it keeps sweeping with d = c = 0) and returns its
    mean, and a non-finite closed form falls back to the mean."""
    m = len(xns)
    if m == 0:
        return np.zeros(0)
    n_max = max(x.shape[0] for x in xns)
    full_pass, ns = _sweep_lanes(list(xns), _padded_rows(n_max, blk), blk,
                                 device)
    total = ns.astype(np.float64) ** 2
    zeros = np.zeros(m)
    _, _, _, sum_s, sum_s2 = full_pass(zeros, zeros).T
    mean = sum_s / total
    var = sum_s2 / total - mean ** 2
    floor = 1e-12 * np.maximum(1.0, mean * mean)
    frozen = ~(var > floor)
    weights = np.full((m, 2), 0.5)
    means = (mean[:, None]
             + np.sqrt(np.maximum(var, 0.0))[:, None] * np.array([-1., 1.]))
    sel = np.array([1.0, -1.0])
    for _ in range(niters):
        frozen |= ~(var > floor)
        active = ~frozen
        if not active.any():
            break
        with np.errstate(all="ignore"):
            d = (means[:, 1] - means[:, 0]) / var
            c = (np.log(weights[:, 1]) - np.log(weights[:, 0])
                 - 0.5 * (means[:, 1] ** 2 - means[:, 0] ** 2) / var)
        d = np.where(active, d, 0.0)
        c = np.where(active, c, 0.0)
        cnt1, s1, s2, _, _ = full_pass(d, c).T
        with np.errstate(all="ignore"):
            cnt0, s0, q0 = total - cnt1, sum_s - s1, sum_s2 - s2
            w_new = np.stack([cnt0, cnt1], axis=1) / total[:, None]
            m_new = np.stack([s0 / cnt0, s1 / cnt1], axis=1)
            second = np.stack([q0 / cnt0, s2 / cnt1], axis=1)
            v_new = ((second - m_new ** 2) * w_new).sum(axis=1)
        weights = np.where(active[:, None], w_new, weights)
        means = np.where(active[:, None], m_new, means)
        var = np.where(active, v_new, var)
    with np.errstate(all="ignore"):
        thr = (-0.5
               * ((np.log(weights ** 2 / var[:, None])
                   - means ** 2 / var[:, None]) @ sel)
               / ((means / var[:, None]) @ sel))
    return np.where(np.isfinite(thr) & ~frozen, thr, mean)
