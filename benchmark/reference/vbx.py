"""Plain float64 VBx: x-vector transform, cosine AHC with the 2-GMM
calibration threshold, and the VB-HMM, the reference the corpus and
serving cells are judged against.

A frozen re-statement of VBx (github.com/BUTSpeechFIT/VBx): the
transform and AHC of vbhmm.py:117-146 (twoGMMcalib_lin of
diarization_lib.py:13-31, exact over all N^2 scores; average linkage on
the negated scores, scipy's in the place of fastcluster's, the same
merges, recordings linked in parallel processes), the PLDA re-diagonalization of vbhmm.py:109-113, the VB inputs
of vbhmm.py:150-153 and the EM of VBx.py:27-126 with its forward-backward
(VBx.py:160-175) in the scaled probability domain, batched over
recordings. It imports nothing of the program; the models and x-vectors
are the benchmark's own arrays.

`stream` names a float type that the large per-iteration streams (rho,
alpha where it meets rho, the E-step product and the posteriors) are
rounded to, as a program with reduced-precision streams stores them: None
keeps float64 (the reference); a float8 type is the control.
"""

import os
from typing import List, Optional, Sequence

import numpy as np
import torch


def transform_xvectors(x_raw, mean1, lda, mean2) -> np.ndarray:
    """Raw x-vectors -> length-normalized LDA space (vbhmm.py:125-129)."""
    x = np.asarray(x_raw, np.float64) - mean1
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x = x @ lda - mean2
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def two_gmm_threshold(scores: torch.Tensor, niters: int = 20) -> float:
    """diarization_lib.twoGMMcalib_lin's threshold over every score
    (float64, shared variance)."""
    s = scores.reshape(-1).to(torch.float64)
    weights = torch.tensor([0.5, 0.5], dtype=s.dtype, device=s.device)
    means = s.mean() + s.std(unbiased=False) * torch.tensor(
        [-1.0, 1.0], dtype=s.dtype, device=s.device)
    var = s.var(unbiased=False)
    thr = float("inf")
    sel = torch.tensor([1.0, -1.0], dtype=s.dtype, device=s.device)
    for _ in range(niters):
        # the posterior of the upper component, as softmax of the two lls
        d = (means[1] - means[0]) / var
        c = (torch.log(weights[1]) - torch.log(weights[0])
             - 0.5 * (means[1] ** 2 - means[0] ** 2) / var)
        g1 = torch.sigmoid(s * d + c)
        cnt1 = g1.sum()
        cnts = torch.stack([s.numel() - cnt1, cnt1])
        weights = cnts / cnts.sum()
        s1, q1 = (g1 * s).sum(), (g1 * s * s).sum()
        means = torch.stack([(s.sum() - s1) / cnts[0], s1 / cnts[1]])
        second = torch.stack([((s * s).sum() - q1) / cnts[0], q1 / cnts[1]])
        var = ((second - means ** 2) * weights).sum()
        thr = float(-0.5 * ((torch.log(weights ** 2 / var)
                             - means ** 2 / var) * sel).sum()
                    / ((means / var) * sel).sum())
    return thr


def _average_linkage(xn: np.ndarray) -> np.ndarray:
    """scipy's average linkage of the negated cosine scores of unit rows
    `xn` (scipy in the place of fastcluster: the same merges)."""
    from scipy.cluster.hierarchy import linkage
    from scipy.spatial.distance import squareform

    s = xn @ xn.T
    np.negative(s, out=s)
    cond = squareform(s, checks=False)      # the upper triangle, by rows
    del s
    return linkage(cond, method="average")


def _cut(Z: np.ndarray, thr: float, threshold_bias: float) -> np.ndarray:
    """vbhmm.py:141-146: the merge heights shifted to be non-negative,
    cut at the calibrated threshold plus the bias; 0-based labels."""
    from scipy.cluster.hierarchy import fcluster

    Z = Z.copy()
    adjust = abs(Z[:, 2].min())
    Z[:, 2] += adjust
    return fcluster(Z, -(thr + threshold_bias) + adjust,
                    criterion="distance") - 1


def ahc_labels(xs: Sequence[np.ndarray], threshold_bias: float,
                    device: str = "cpu") -> List[np.ndarray]:
    """Cosine AHC of each recording's transformed x-vectors
    (vbhmm.py:131-146): 0-based labels [N] each. Where the linkages are
    long (N^2 summed over 1e8), they run in spawned worker processes
    (scipy's holds the GIL), one a core but one, longest first, while
    this process computes the 2-GMM thresholds on `device`; every worker
    has ended on return."""
    import multiprocessing

    xns = [np.asarray(x, np.float64) for x in xs]
    xns = [x / np.linalg.norm(x, axis=1, keepdims=True) for x in xns]
    todo = sorted((i for i, x in enumerate(xns) if len(x) > 1),
                  key=lambda i: -len(xns[i]))
    workers = min(len(todo), (os.cpu_count() or 1) - 1)
    if sum(len(xns[i]) ** 2 for i in todo) <= 1e8:
        workers = 0
    pool = (multiprocessing.get_context("spawn").Pool(workers)
            if workers > 1 else None)
    try:
        jobs = {i: pool.apply_async(_average_linkage, (xns[i],))
                for i in todo} if pool is not None else {}
        thrs = {}
        for i in todo:
            xt = torch.as_tensor(xns[i], device=device)
            thrs[i] = two_gmm_threshold(xt @ xt.T)
            del xt
        Zs = {i: jobs[i].get() if pool is not None
              else _average_linkage(xns[i]) for i in todo}
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    return [_cut(Zs[i], thrs[i], threshold_bias) if i in Zs
            else np.zeros(len(x), np.int64) for i, x in enumerate(xns)]


def rediagonalize_plda(mu, tr, psi):
    """vbhmm.py:109-113: the across-class / within-class generalized
    eigenproblem, eigenvalues descending."""
    import scipy.linalg

    W = np.linalg.inv(tr.T @ tr)
    B = np.linalg.inv((tr.T / psi) @ tr)
    acvar, wccn = scipy.linalg.eigh(B, W)
    return mu, wccn.T[::-1], acvar[::-1]


def vb_inputs(x: np.ndarray, labels: np.ndarray, plda, lda_dim: int,
              smoothing: float):
    """(features [T, lda_dim], phi [lda_dim], qinit [T, S]) of
    vbhmm.py:150-153."""
    mu, tr, psi = rediagonalize_plda(*plda)
    fea = (x - mu) @ tr.T[:, :lda_dim]
    S = int(labels.max()) + 1
    z = np.zeros((len(labels), S))
    z[np.arange(len(labels)), labels] = smoothing
    z = np.exp(z - z.max(1, keepdims=True))
    return fea, psi[:lda_dim], z / z.sum(1, keepdims=True)


def _round(a: np.ndarray, stream) -> np.ndarray:
    if stream is None:
        return a
    t = torch.from_numpy(np.ascontiguousarray(a))
    if stream in (torch.float8_e4m3fn, torch.float8_e5m2):
        lim = torch.finfo(stream).max
        t = t.clamp(-lim, lim)
    return t.to(stream).to(torch.float64).numpy()


def vbx_batch(feas: Sequence[np.ndarray], phi: np.ndarray,
              qinits: Sequence[np.ndarray], loop_prob: float, Fa: float,
              Fb: float, iters: int, stream=None):
    """VBx's EM run for `iters` iterations on each recording, the
    recordings batched (padded frames and speakers masked out). Returns
    ([gamma [T, S]], elbo [B, iters])."""
    B = len(feas)
    D = feas[0].shape[1]
    Ts = np.array([len(f) for f in feas])
    Ss = np.array([q.shape[1] for q in qinits])
    T, S = Ts.max(), Ss.max()
    X = np.zeros((B, T, D))
    gamma = np.zeros((B, T, S))
    fmask = np.arange(T)[None, :] < Ts[:, None]              # [B, T]
    smask = np.arange(S)[None, :] < Ss[:, None]              # [B, S]
    for b in range(B):
        X[b, :Ts[b]] = feas[b]
        gamma[b, :Ts[b], :Ss[b]] = qinits[b]
    pi = smask / Ss[:, None]
    G = -0.5 * ((X ** 2).sum(-1) + D * np.log(2 * np.pi))     # [B, T]
    rho = _round(X * np.sqrt(phi), stream)
    eps = 1e-8
    ends = {}
    for b in range(B):
        ends.setdefault(int(Ts[b]) - 1, []).append(b)
    elbos = np.zeros((B, iters))
    for it in range(iters):
        gamma = _round(gamma, stream)
        counts = gamma.sum(1)                                  # [B, S]
        invL = 1.0 / (1.0 + Fa / Fb * counts[:, :, None] * phi)
        alpha = Fa / Fb * invL * (gamma.transpose(0, 2, 1) @ rho)
        cross = _round(rho @ _round(alpha, stream).transpose(0, 2, 1),
                       stream)
        log_p = Fa * (cross - 0.5 * ((invL + alpha ** 2) @ phi)[:, None, :]
                      + G[:, :, None])
        log_p = np.where(smask[:, None, :], log_p, -np.inf)
        m = log_p.max(-1)                                      # [B, T]
        lik = np.ascontiguousarray(
            np.exp(log_p - m[:, :, None]).transpose(1, 0, 2))  # [T, B, S]
        col = np.where(smask, (1.0 - loop_prob) * pi + eps, 0.0)
        # padded frames run on through the recursions (X = 0 there keeps
        # them finite); they are masked out of every sum, and each
        # recording's backward pass starts at its own last frame
        a_hat = np.empty((T, B, S))
        c = np.empty((T, B))
        a = lik[0] * np.where(smask, pi + eps, 0.0)
        c[0] = a.sum(-1)
        a_hat[0] = a / c[0][:, None]
        for t in range(1, T):
            a = a_hat[t - 1] * loop_prob
            a += col
            a *= lik[t]
            ct = a.sum(-1)
            c[t] = ct
            np.divide(a, ct[:, None], out=a_hat[t])
        b_hat = np.empty((T, B, S))
        b_hat[T - 1] = 1.0
        for t in range(T - 2, -1, -1):
            v = lik[t + 1] * b_hat[t + 1]
            nb = v * loop_prob
            nb += np.einsum("bs,bs->b", col, v)[:, None]
            nb /= c[t + 1][:, None]
            b_hat[t] = nb
            if t in ends:
                b_hat[t, ends[t]] = 1.0
        valid = fmask.T                                        # [T, B]
        log_px = np.where(valid, np.log(c) + m.T, 0.0).sum(0)  # [B]
        g = (a_hat * b_hat).transpose(1, 0, 2) * fmask[:, :, None]
        pi_stat = (lik[1:] * b_hat[1:] / c[1:, :, None]
                   * valid[1:, :, None]).sum(0)                # [B, S]
        with np.errstate(divide="ignore", invalid="ignore"):
            model = np.where(smask[:, :, None],
                             np.log(invL) - invL - alpha ** 2 + 1.0, 0.0)
        elbos[:, it] = log_px + Fb * 0.5 * model.sum((1, 2))
        new_pi = g[:, 0] + (1.0 - loop_prob) * pi * pi_stat
        pi = new_pi / new_pi.sum(-1, keepdims=True)
        gamma = g
    gammas: List[np.ndarray] = [gamma[b, :Ts[b], :Ss[b]] for b in range(B)]
    return gammas, elbos


def diarize(recs_x: Sequence[np.ndarray], plda, transform, cfg: dict,
            device: str = "cpu", stream=None,
            labels_init: Optional[Sequence[np.ndarray]] = None):
    """Transform, AHC and VB for each recording's raw x-vectors under the
    configuration's settings `cfg` (threshold_bias, init_smoothing,
    loop_prob, Fa, Fb, max_iters, lda_dim). Returns (AHC labels [N],
    final labels [N], elbo [iters]) per recording."""
    xs = [transform_xvectors(x, *transform) for x in recs_x]
    ahc = (list(labels_init) if labels_init is not None else
           ahc_labels(xs, cfg["threshold_bias"], device))
    ins = [vb_inputs(x, lab, plda, cfg["lda_dim"], cfg["init_smoothing"])
           for x, lab in zip(xs, ahc)]
    gammas, elbos = vbx_batch([f for f, _, _ in ins], ins[0][1],
                              [q for _, _, q in ins], cfg["loop_prob"],
                              cfg["Fa"], cfg["Fb"], cfg["max_iters"],
                              stream=stream)
    return [(a, g.argmax(1), e) for a, g, e in zip(ahc, gammas, elbos)]
