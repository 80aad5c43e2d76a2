"""Debug oracle for the VB-HMM engine: per-iteration diagnostics against a
frame-level reference labeling (capability parity with the reference's
`VBx(ref=...)` trace — VBx/VBx.py:105-120,134-143 — which records
[ELBO, DER, cross-entropy] per EM iteration).

Port of vbx_tpu.engine.debug. Runs the EM loop eagerly on the chosen device
(one step per iteration, host round-trip for the Hungarian assignment) — a
debugging tool, not the throughput path.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from vbx_tpu_torch.device import full_fp32_matmuls, resolve_device
from vbx_tpu_torch.ops.forward_backward import forward_backward_structured
from vbx_tpu_torch.ops.vb_steps import (vb_elbo_model_term,
                                        vb_log_likelihoods, vb_m_step,
                                        vb_pi_update, vb_precompute)


def frame_der(q: np.ndarray, ref: np.ndarray, expected: bool = True,
              xentropy: bool = False) -> float:
    """Expected/hard frame DER or cross-entropy between posteriors q [T, S]
    and zero-based integer reference labels ref [T], under the optimal
    one-to-one speaker mapping (reference semantics VBx/VBx.py:134-143,
    including its (T + min_cost)/T form, where min_cost sums -q over the
    optimally mapped speaker — i.e. the fraction of frames NOT credited to
    the mapped speaker)."""
    q = np.asarray(q, float)
    ref = np.asarray(ref, int)
    T = len(ref)
    if not expected:
        hard = np.zeros_like(q)
        hard[np.arange(T), q.argmax(1)] = 1.0
        q = hard
    ref_mx = np.zeros((T, ref.max() + 1))
    ref_mx[np.arange(T), ref] = 1.0
    err = ref_mx.T @ (-np.log(q + np.nextafter(0, 1)) if xentropy else -q)
    rows, cols = linear_sum_assignment(err)
    min_cost = err[rows, cols].sum()
    return (min_cost / T) if xentropy else (T + min_cost) / T


class DebugTrace(NamedTuple):
    elbo: float
    der: float
    xent: float


def vbx_debug(
    X,
    phi,
    gamma,
    pi,
    ref_labels: Optional[np.ndarray] = None,
    loop_prob: float = 0.9,
    Fa: float = 1.0,
    Fb: float = 1.0,
    max_iters: int = 40,
    epsilon: float = 1e-6,
    plot_path: Optional[str] = None,
    device=None,
):
    """EM loop with a per-iteration [ELBO, DER, xent] trace.

    Returns (gamma, pi, List[DebugTrace]) with gamma and pi as numpy
    arrays. Matches the engine's fixed point (same ops modules) while
    exposing every iteration. The EM runs at X's dtype on `device` ('cuda'
    unless the caller passes 'cpu'); the Hungarian step runs on the host.

    `plot_path`: write the reference's debug figure (VBx.py:111-120 —
    one subplot per EM iteration: responsibility trajectories over the
    reference labeling as a pastel background strip) to this file.
    Headless-safe (Agg backend); requires matplotlib.
    """
    if max_iters < 1:
        raise ValueError(f"max_iters must be >= 1, got {max_iters}")
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    phi = torch.as_tensor(phi, device=dev).to(X.dtype)
    gamma = torch.as_tensor(gamma, device=dev).to(X.dtype)
    pi = torch.as_tensor(pi, device=dev).to(X.dtype)
    G, rho = vb_precompute(X, phi)
    trace: List[DebugTrace] = []
    _plot_gammas: List[np.ndarray] = []
    for it in range(max_iters):
        with full_fp32_matmuls():
            invL, alpha = vb_m_step(gamma, rho, phi, Fa / Fb)
            log_p = vb_log_likelihoods(rho, G, invL, alpha, phi, Fa)
        fbr = forward_backward_structured(log_p, pi, loop_prob)
        elbo = float(fbr.log_px + vb_elbo_model_term(invL, alpha, Fb))
        pi = vb_pi_update(fbr.gamma[0], pi, fbr.pi_stat, loop_prob)
        gamma = fbr.gamma
        q = gamma.cpu().numpy()
        if ref_labels is not None:
            trace.append(DebugTrace(
                elbo,
                frame_der(q, ref_labels, expected=True),
                frame_der(q, ref_labels, expected=True, xentropy=True)))
        else:
            trace.append(DebugTrace(elbo, float("nan"), float("nan")))
        if plot_path is not None:
            _plot_gammas.append(q)
        if it > 0 and trace[-1].elbo - trace[-2].elbo < epsilon:
            break
    if plot_path is not None:
        _plot_gamma_trace(_plot_gammas, ref_labels, plot_path)
    return q, pi.cpu().numpy(), trace


def _plot_gamma_trace(gammas: List[np.ndarray],
                      ref_labels: Optional[np.ndarray],
                      plot_path: str) -> None:
    """Reference debug figure (VBx.py:111-120): one subplot per EM
    iteration, speaker-responsibility trajectories drawn over the
    reference labeling as a pastel background strip. Saved to a file
    instead of an interactive window (headless hosts)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = max(len(gammas), 1)
    fig, axes = plt.subplots(n, 1, figsize=(10, 1.6 * n), squeeze=False)
    for i, q in enumerate(gammas):
        ax = axes[i, 0]
        if ref_labels is not None:
            ax.imshow(np.atleast_2d(ref_labels), interpolation="none",
                      aspect="auto", cmap="Pastel1",
                      extent=(0, len(q), -0.05, 1.05))
        ax.plot(q, lw=2)
        ax.set_ylabel(f"iter {i}", fontsize=8)
        ax.set_xlim(0, len(q))
    fig.savefig(plot_path, bbox_inches="tight")
    plt.close(fig)
