"""The multi-device dryrun (port of `dryrun_multichip` in vbx_tpu's
__graft_entry__.py): an n-device ('dp', 'sp') mesh, and on it the four
things the mesh must hold to its one-device answer.

1. vbx_sharded on the structured route;
2. its kernel route (fb_impl='pallas': K2 + K1 on every shard) with the
   opt-in plateau stop;
3. the checkpointed engine, vbx_batched_checkpointed(mesh=) in two slices,
   bit-equal to the one-shot sharded run;
4. a DiarizationService(mesh=) request equal to the no-mesh service's.

The shapes, seeds and factoring are vbx_tpu's: n = n_dp x n_sp with
n_sp = 2 when n is even; B = 2 n_dp recordings of T = 16 n_sp frames,
S = 4, D = 8, with a padded frame tail and a padded speaker.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None,
                     device=None) -> dict:
    """Run the four checks on an n_devices mesh and return what ran:
    {"mesh": {'dp': n_dp, 'sp': n_sp}, "devices": [names], "checks":
    [the four checks' names]}. Raises RuntimeError when a check fails.

    devices and device pick the mesh's devices as make_mesh does: an
    explicit list (it may repeat a device; its first n_devices are used),
    or 'cuda' (the default: the visible cards) or 'cpu' (copies of the
    CPU). Too few devices raise ValueError."""
    from vbx_tpu_torch.engine.vbhmm import vbx_batched_checkpointed
    from vbx_tpu_torch.parallel import make_mesh, vbx_sharded

    # factor n into dp x sp: frames sequence-parallel, recordings data-
    # parallel, the two axes this inference workload admits
    n_sp = 2 if n_devices % 2 == 0 else 1
    n_dp = n_devices // n_sp
    mesh = make_mesh(n_dp=n_dp, n_sp=n_sp, devices=devices, device=device)
    dev0 = mesh.first_device

    B, T, S, D = 2 * n_dp, 16 * n_sp, 4, 8
    rng = np.random.default_rng(0)
    f32 = torch.float32
    X = torch.as_tensor(rng.standard_normal((B, T, D)), dtype=f32)
    phi = torch.as_tensor(rng.uniform(0.5, 3.0, D), dtype=f32)
    gamma = torch.as_tensor(rng.dirichlet(np.ones(S), size=(B, T)),
                            dtype=f32)
    pi = torch.full((B, S), 1.0 / S, dtype=f32)
    fm = torch.ones((B, T), dtype=torch.bool)
    fm[0, -4:] = False                    # exercise frame padding
    sm = torch.ones((B, S), dtype=torch.bool)
    sm[-1, -1] = False                    # exercise speaker padding
    args = [a.to(dev0) for a in (X, phi, gamma, pi, fm, sm)]
    kw = dict(loop_prob=0.9, Fa=0.4, Fb=11.0, epsilon=1e-6)

    def finite(res, what):
        _check(tuple(res.gamma.shape) == (B, T, S),
               f"{what}: gamma shape {tuple(res.gamma.shape)}")
        _check(bool(torch.isfinite(res.pi).all()), f"{what}: non-finite pi")

    finite(vbx_sharded(mesh, *args, max_iters=3, **kw), "structured route")
    finite(vbx_sharded(mesh, *args, max_iters=3, fb_impl="pallas",
                       plateau_ulps=4.0, plateau_iters=2, **kw),
           "kernel route")

    # the checkpointed sharded engine: a two-slice run must follow the
    # one-shot sharded run's trajectory exactly
    res_ck = vbx_batched_checkpointed(*args, max_iters=4, iters_per_slice=2,
                                      mesh=mesh, **kw)
    res_one = vbx_sharded(mesh, *args, max_iters=4, **kw)
    _check(torch.equal(res_ck.gamma.cpu(), res_one.gamma.cpu())
           and torch.equal(res_ck.n_iters.cpu(), res_one.n_iters.cpu()),
           "the two-slice checkpointed run differs from the one-shot run")

    _dryrun_serving_mesh(mesh)
    return {"mesh": dict(mesh.shape),
            "devices": [str(d) for row in mesh.devices for d in row],
            "checks": ["structured", "kernel+plateau", "checkpointed",
                       "serving"]}


def _dryrun_serving_mesh(mesh) -> None:
    """A DiarizationService(mesh=) request against the no-mesh service on
    the mesh's first device, on a synthetic recording and synthetic models
    (no reference assets)."""
    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.serving import DiarizationService

    rng = np.random.default_rng(1)
    d_raw, d_plda = 32, 16
    # synthetic transform (mean1 [d_raw], lda [d_raw, d_plda], mean2
    # [d_plda]) and PLDA (mu/psi [d_plda], invertible tr) in the shapes the
    # Kaldi assets carry, just smaller
    transform = (rng.standard_normal(d_raw) * 0.01,
                 rng.standard_normal((d_raw, d_plda)) / np.sqrt(d_raw),
                 rng.standard_normal(d_plda) * 0.01)
    plda = (rng.standard_normal(d_plda) * 0.01,
            np.eye(d_plda) + 0.1 * rng.standard_normal((d_plda, d_plda)),
            np.linspace(3.0, 0.5, d_plda))
    cfg = dataclasses.replace(get_preset("example"), lda_dim=d_plda)

    # ~3 well-separated synthetic speakers over 48 x-vectors
    n_vec = 48
    centers = rng.standard_normal((3, d_raw)) * 4.0
    z = np.repeat(np.arange(3), n_vec // 3)
    x_raw = (centers[z] + 0.3 * rng.standard_normal((n_vec, d_raw))
             ).astype(np.float32)
    ts = np.stack([np.arange(n_vec) * 0.24,
                   np.arange(n_vec) * 0.24 + 1.44], 1)

    dev = mesh.first_device
    with DiarizationService(cfg, plda, transform, device=dev) as svc_solo:
        ref = svc_solo.submit("dryrun_rec", x_raw, ts).result(timeout=300)
    with DiarizationService(cfg, plda, transform, mesh=mesh,
                            device=dev) as svc_mesh:
        got = svc_mesh.submit("dryrun_rec", x_raw, ts).result(timeout=300)
    _check(np.array_equal(got.labels1st, ref.labels1st)
           and got.rttm == ref.rttm and got.n_speakers == ref.n_speakers,
           "the service on the mesh differs from the service without it")
