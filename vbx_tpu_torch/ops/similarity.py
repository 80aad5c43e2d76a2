"""PLDA similarity for AHC initialization (port of the host routes of
vbx_tpu.ops.similarity).

Cosine scores need no function of their own here: the AHC host chain takes
xn @ xn.T of the length-normalized float64 x-vectors directly
(engine.ahc). PLDA log-likelihood-ratio scoring (diarization_lib.py:34-56)
is one rank-D product plus rank-1 row/column corrections.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def plda_scoring_in_lda_space(Fe: torch.Tensor, Ft: torch.Tensor,
                              diag_ac: torch.Tensor) -> torch.Tensor:
    """Pairwise PLDA log-likelihood-ratio scores for LDA-transformed,
    length-normalized vectors with diagonal across-class covariance diag_ac
    (reference: diarization_lib.PLDA_scoring_in_LDA_space:34-56, following
    Burget et al., ICASSP 2011 eqs. 7-8). Runs at Fe's dtype on Fe's
    device. Returns [N, M]."""
    dtype = Fe.dtype
    diag_ac = diag_ac.to(dtype)
    iTC = 1.0 / (1.0 + diag_ac)
    iWC2AC = 1.0 / (1.0 + 2.0 * diag_ac)
    ld_tc = torch.log1p(diag_ac).sum()
    ld_wc2ac = torch.log1p(2.0 * diag_ac).sum()
    gamma_ = -0.25 * (iWC2AC + 1.0 - 2.0 * iTC)
    lambda_ = -0.5 * (iWC2AC - 1.0)
    k = -0.5 * (ld_wc2ac - 2.0 * ld_tc)
    cross = torch.matmul(Fe * lambda_, Ft.T)
    qe = torch.matmul(Fe * Fe, gamma_[:, None])
    qt = torch.matmul(Ft * Ft, gamma_[:, None])
    return cross + qe + qt.T + k


def kaldi_plda_scoring_dense(
    plda: Tuple[np.ndarray, np.ndarray, np.ndarray],
    x: np.ndarray,
    target_energy: float = 0.1,
    pca_dim: Optional[int] = None,
) -> np.ndarray:
    """Kaldi-recipe-equivalent dense PLDA similarity matrix with
    per-recording PCA (reference: diarization_lib.
    kaldi_ivector_plda_scoring_dense:59-93), all in float64 on the host.

    The tiny per-recording eigendecompositions (R x R with R <= 256) are
    model prep; the N x N scoring product runs through
    `plda_scoring_in_lda_space` on float64 CPU tensors. (vbx_tpu hands that
    product to the accelerator at the JAX default dtype, float32 unless x64
    is enabled; the port's init chain stays float64 throughout.)
    """
    import scipy.linalg

    from vbx_tpu_torch.utils.hostblas import single_thread_blas

    plda_mu, plda_tr, plda_psi = plda
    cov = np.cov(x.T, bias=True)
    # tiny (<=256x256) per-recording LAPACK: pinned to one BLAS thread —
    # the multi-threaded path is load-dependently ~200x slower at this
    # size (utils/hostblas.py)
    with single_thread_blas():
        energy, PCA = scipy.linalg.eigh(cov)
        if pca_dim is None:
            energy = np.cumsum(energy[::-1])
            # at least 2 dims: 2 extra are always added (reference :81-82)
            pca_dim = int(np.sum(energy / energy[-1] <= target_energy) + 2)
        PCA = PCA[:, :-pca_dim - 1:-1]

        plda_tr_inv_pca = PCA.T @ np.linalg.inv(plda_tr)
        W = plda_tr_inv_pca @ plda_tr_inv_pca.T
        B = (plda_tr_inv_pca * plda_psi) @ plda_tr_inv_pca.T
        acvar, wccn = scipy.linalg.eigh(B, W)
    x = (x - plda_mu) @ PCA @ wccn
    # kaldi-style length norm (reference :92)
    x *= np.sqrt(x.shape[1] / (x ** 2 @ (1.0 / (acvar + 1.0))))[:, None]
    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))
    scores = plda_scoring_in_lda_space(
        xt, xt, torch.from_numpy(np.asarray(acvar, np.float64)))
    return scores.numpy()
