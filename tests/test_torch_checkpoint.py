"""vbx_batched_checkpointed of the port (vbx_tpu_torch.engine.vbhmm): exact
slicing against the port's own unsliced run, resume after a simulated stop,
the legacy header, and checkpoint files exchanged with vbx_tpu in both
directions (solo and on the CPU mesh).

Bit-equality holds within one package at a fixed padded shape (the loop
state is externalized, so a sliced run executes the same per-iteration
program). Across the packages the float64 trajectories agree to 1e-9 (the
two implementations sum in different orders), so a run resumed from the
other package's file is held to 1e-9 and to equal iteration counts.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vbx_tpu.engine.vbhmm as jvb
import vbx_tpu.parallel as jpar
import vbx_tpu_torch.engine.vbhmm as tvb
import vbx_tpu_torch.parallel as tpar
from vbx_tpu_torch.testing import host_threads

from .oracle import random_vb_problem


# several test workers share the host: keep this file's pools to one thread
@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    with host_threads(1):
        yield


def _problem(B=6, T=50, S=5, D=8, seed=7, dtype=np.float32):
    """tests/test_engine.py's checkpoint problem: lane 1 has a padded
    suffix."""
    rng = np.random.default_rng(seed)
    problems = [random_vb_problem(rng, T, S, D) for _ in range(B)]
    phi = problems[0][1].astype(dtype)
    X = np.stack([p[0] for p in problems]).astype(dtype)
    G = np.stack([p[2] for p in problems]).astype(dtype)
    PI = np.stack([p[3] for p in problems]).astype(dtype)
    FM = np.ones((B, T), bool)
    SM = np.ones((B, S), bool)
    FM[1, 35:] = False
    X[1, 35:] = 0
    G[1, 35:] = 0
    kw = dict(loop_prob=0.9, Fa=0.4, Fb=11.0, max_iters=25, epsilon=1e-5)
    return (X, phi, G, PI, FM, SM), kw


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(out, ref, model_atol=2e-3):
    np.testing.assert_array_equal(_np(out.n_iters), _np(ref.n_iters))
    np.testing.assert_array_equal(_np(out.gamma), _np(ref.gamma))
    np.testing.assert_array_equal(_np(out.pi), _np(ref.pi))
    np.testing.assert_array_equal(_np(out.elbo), _np(ref.elbo))
    if model_atol is not None:
        # the wrapper recomputes the model from the final gamma; the
        # structured run returns the crossing iteration's: equal to
        # convergence tolerance
        np.testing.assert_allclose(_np(out.alpha), _np(ref.alpha),
                                   atol=model_atol)


def _stop_after(monkeypatch, mod, name, n_calls):
    """Make mod.<name> raise KeyboardInterrupt on call n_calls + 1 (a
    simulated stop); returns the undo."""
    real = getattr(mod, name)
    calls = {"n": 0}

    def dying(*a, **k):
        calls["n"] += 1
        if calls["n"] > n_calls:
            raise KeyboardInterrupt("simulated stop")
        return real(*a, **k)

    monkeypatch.setattr(mod, name, dying)
    return lambda: monkeypatch.setattr(mod, name, real)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("iters_per_slice", [3, 7])
def test_slicing_is_exact(iters_per_slice, dtype):
    args, kw = _problem(dtype=dtype)
    if dtype == np.float64:
        kw["epsilon"] = 1e-9   # exercise deltas below f32 resolution
    ref = tvb.vbx_batched(*args, **kw, device="cpu")
    out = tvb.vbx_batched_checkpointed(*args, **kw, device="cpu",
                                       iters_per_slice=iters_per_slice)
    assert out.elbo.dtype == ref.elbo.dtype == getattr(torch, dtype.__name__)
    assert out.n_iters.dtype == torch.int32
    _same(out, ref)


@pytest.mark.parametrize("iters_per_slice", [2, 5])
def test_plateau_slicing_is_exact(iters_per_slice):
    """The plateau counter is part of the externalized loop state: slicing
    through a plateau crossing is bit-exact (the host replays the engine's
    counter over the recorded deltas)."""
    args, kw = _problem(B=5, seed=3)
    kw = {**kw, "epsilon": 0.0, "max_iters": 30, "plateau_ulps": 4.0,
          "plateau_iters": 2}
    ref = tvb.vbx_batched(*args, **kw, device="cpu")
    assert int(ref.n_iters.max()) < 30           # the plateau rule fired
    out = tvb.vbx_batched_checkpointed(*args, **kw, device="cpu",
                                       iters_per_slice=iters_per_slice)
    _same(out, ref, model_atol=None)


@pytest.mark.parametrize("fb_impl", ["pallas", "assoc"])
def test_other_routes_slice_exactly(fb_impl):
    """The kernel route (its twin on the CPU) and the assoc route slice
    exactly too; the kernel route's state is float32 whatever X is."""
    args, kw = _problem(B=4, T=40) if fb_impl == "assoc" else _problem(B=18)
    ref = tvb.vbx_batched(*args, **kw, fb_impl=fb_impl, device="cpu")
    out = tvb.vbx_batched_checkpointed(*args, **kw, fb_impl=fb_impl,
                                       iters_per_slice=4, device="cpu")
    _same(out, ref, model_atol=None if fb_impl == "pallas" else 2e-3)
    if fb_impl == "pallas":
        # the kernel route returns the final-gamma model as well
        np.testing.assert_allclose(_np(out.alpha), _np(ref.alpha), atol=1e-6)


def test_resume_after_a_simulated_stop(tmp_path, monkeypatch):
    """Stop the run after its first slice; a rerun loads the file,
    continues from the saved state and reproduces the uninterrupted result
    exactly. The file is removed on completion."""
    args, kw = _problem()
    ref = tvb.vbx_batched(*args, **kw, device="cpu")
    ck = str(tmp_path / "vb_state.npz")
    undo = _stop_after(monkeypatch, tvb, "vbx_batched", 1)
    with pytest.raises(KeyboardInterrupt):
        tvb.vbx_batched_checkpointed(*args, **kw, iters_per_slice=5,
                                     checkpoint_path=ck, device="cpu")
    undo()
    assert os.path.exists(ck)                    # slice 1's state survived
    assert not os.path.exists(ck + ".tmp.npz")   # written by rename
    with np.load(ck) as f:
        assert int(f["it_done"]) == 5
        assert sorted(f.files) == sorted(
            ["gamma", "pi", "converged", "last_elbo", "plateau", "elbo",
             "it_done", "shape", "fb_impl", "dtype", "hp"])
        assert str(f["fb_impl"]) == "structured"
        assert str(f["dtype"]) == "float32" and f["hp"].shape == (7,)

    out = tvb.vbx_batched_checkpointed(*args, **kw, iters_per_slice=5,
                                       checkpoint_path=ck, device="cpu")
    assert not os.path.exists(ck)                # removed on success
    _same(out, ref)

    # resuming an already-complete file also works (stopped between the
    # final slice's write and the clean-up)
    def fake_ck():
        B = out.pi.shape[0]
        np.savez(ck + ".tmp.npz", gamma=_np(out.gamma), pi=_np(out.pi),
                 converged=np.ones(B, bool),
                 last_elbo=np.nanmax(_np(out.elbo), axis=1),
                 plateau=np.zeros(B, np.int32), elbo=_np(out.elbo),
                 it_done=int(out.n_iters.max()),
                 shape=np.array(out.gamma.shape),
                 fb_impl=np.str_("structured"), dtype=np.str_("float32"),
                 hp=np.array([kw["loop_prob"], kw["Fa"], kw["Fb"],
                              kw["epsilon"], float(kw["max_iters"]),
                              0.0, 2.0]))
        os.replace(ck + ".tmp.npz", ck)

    fake_ck()
    out2 = tvb.vbx_batched_checkpointed(*args, **kw, iters_per_slice=5,
                                        checkpoint_path=ck, device="cpu")
    np.testing.assert_array_equal(_np(out2.gamma), _np(out.gamma))
    np.testing.assert_allclose(_np(out2.alpha), _np(ref.alpha), atol=2e-3)

    # a file written by a differently configured run refuses to resume
    for change in ({"epsilon": 3e-4}, {"fb_impl": "pallas"},
                   {"plateau_ulps": 4.0}):
        fake_ck()
        with pytest.raises(ValueError, match="differently-configured"):
            tvb.vbx_batched_checkpointed(
                *args, **{**kw, **change}, iters_per_slice=5,
                checkpoint_path=ck, device="cpu")
    os.remove(ck)

    with pytest.raises(ValueError, match="iters_per_slice"):
        tvb.vbx_batched_checkpointed(*args, **kw, iters_per_slice=0,
                                     device="cpu")


def test_resumes_the_legacy_five_element_header(tmp_path):
    """An early checkpoint (5-element hp, no 'plateau' array) resumes under
    the implied defaults (plateau off); a plateau-enabled run refuses it."""
    args, kw = _problem()
    ref = tvb.vbx_batched(*args, **kw, device="cpu")
    ck = str(tmp_path / "vb_state.npz")

    def legacy_ck():
        B = ref.pi.shape[0]
        np.savez(ck + ".tmp.npz", gamma=_np(ref.gamma), pi=_np(ref.pi),
                 converged=np.ones(B, bool),
                 last_elbo=np.nanmax(_np(ref.elbo), axis=1),
                 elbo=_np(ref.elbo), it_done=int(ref.n_iters.max()),
                 shape=np.array(ref.gamma.shape),
                 fb_impl=np.str_("structured"), dtype=np.str_("float32"),
                 hp=np.array([kw["loop_prob"], kw["Fa"], kw["Fb"],
                              kw["epsilon"], float(kw["max_iters"])]))
        os.replace(ck + ".tmp.npz", ck)

    legacy_ck()
    out = tvb.vbx_batched_checkpointed(*args, **kw, iters_per_slice=5,
                                       checkpoint_path=ck, device="cpu")
    np.testing.assert_array_equal(_np(out.gamma), _np(ref.gamma))
    legacy_ck()
    with pytest.raises(ValueError, match="differently-configured"):
        tvb.vbx_batched_checkpointed(*args, **kw, iters_per_slice=5,
                                     checkpoint_path=ck, plateau_ulps=4.0,
                                     device="cpu")


def test_kernel_route_past_capacity_keeps_the_engine_dtype():
    """On the CPU a kernel route past the kernel's capacity warns once and
    runs the structured engine, resolved BEFORE committing to the kernel
    route's float32 state: a float64 trajectory stays float64 and equals
    the structured checkpointed run bit for bit."""
    rng = np.random.default_rng(2)
    B, T, S, D = 2, 12, tvb.S_MAX + 2, 4
    X = rng.standard_normal((B, T, D))
    phi = rng.uniform(0.5, 2.0, D)
    G = rng.dirichlet(np.ones(S), size=(B, T))
    PI = np.full((B, S), 1.0 / S)
    FM = np.ones((B, T), bool)
    SM = np.ones((B, S), bool)
    kw = dict(loop_prob=0.9, Fa=0.4, Fb=11.0, max_iters=4, epsilon=1e-9,
              iters_per_slice=3, device="cpu")
    ref = tvb.vbx_batched_checkpointed(X, phi, G, PI, FM, SM, **kw)
    with pytest.warns(UserWarning, match=f"{tvb.S_MAX} speakers") as rec:
        out = tvb.vbx_batched_checkpointed(X, phi, G, PI, FM, SM, **kw,
                                           fb_impl="pallas")
    assert len([w for w in rec if "speakers" in str(w.message)]) == 1
    _same(out, ref, model_atol=None)
    assert out.elbo.dtype == ref.elbo.dtype == torch.float64


def _f64_problem():
    args, kw = _problem(dtype=np.float64)
    return args, {**kw, "epsilon": 1e-9}


def test_a_file_written_by_vbx_tpu_resumes_in_the_port(tmp_path,
                                                       monkeypatch):
    """vbx_tpu's checkpointed run is stopped after its first slice; the
    port loads that file and finishes the run: float64 ELBO trace and gamma
    within 1e-9 of vbx_tpu's own uninterrupted run, equal iteration
    counts, and the file removed."""
    args, kw = _f64_problem()
    jargs = tuple(map(jnp.asarray, args))
    ref = jvb.vbx_batched(*jargs, **kw)
    ck = str(tmp_path / "vb_state.npz")
    undo = _stop_after(monkeypatch, jvb, "vbx_batched", 1)
    with pytest.raises(KeyboardInterrupt):
        jvb.vbx_batched_checkpointed(*jargs, **kw, iters_per_slice=5,
                                     checkpoint_path=ck)
    undo()
    assert os.path.exists(ck)
    out = tvb.vbx_batched_checkpointed(*args, **kw, iters_per_slice=5,
                                       checkpoint_path=ck, device="cpu")
    assert not os.path.exists(ck)
    np.testing.assert_array_equal(_np(out.n_iters), _np(ref.n_iters))
    # the first slice is vbx_tpu's own, bit for bit
    np.testing.assert_array_equal(_np(out.elbo)[:, :5], _np(ref.elbo)[:, :5])
    np.testing.assert_allclose(_np(out.elbo), _np(ref.elbo), rtol=1e-9)
    np.testing.assert_allclose(_np(out.gamma), _np(ref.gamma), atol=1e-9)


def test_a_file_written_by_the_port_resumes_in_vbx_tpu(tmp_path,
                                                       monkeypatch):
    args, kw = _f64_problem()
    ref = tvb.vbx_batched(*args, **kw, device="cpu")
    ck = str(tmp_path / "vb_state.npz")
    undo = _stop_after(monkeypatch, tvb, "vbx_batched", 1)
    with pytest.raises(KeyboardInterrupt):
        tvb.vbx_batched_checkpointed(*args, **kw, iters_per_slice=5,
                                     checkpoint_path=ck, device="cpu")
    undo()
    out = jvb.vbx_batched_checkpointed(*map(jnp.asarray, args), **kw,
                                       iters_per_slice=5, checkpoint_path=ck)
    assert not os.path.exists(ck)
    np.testing.assert_array_equal(_np(out.n_iters), _np(ref.n_iters))
    np.testing.assert_array_equal(_np(out.elbo)[:, :5], _np(ref.elbo)[:, :5])
    np.testing.assert_allclose(_np(out.elbo), _np(ref.elbo), rtol=1e-9)
    np.testing.assert_allclose(_np(out.gamma), _np(ref.gamma), atol=1e-9)


@pytest.mark.parametrize("fb_impl,want", [
    (None, "sharded[dp=2,sp=2]"), ("pallas", "sharded[dp=2,sp=2]+pallas")])
def test_mesh_form_on_the_cpu_mesh(tmp_path, monkeypatch, fb_impl, want):
    """The mesh= form on a 2x2 mesh of CPU copies: sliced and resumed after
    a simulated stop it equals the port's unsliced vbx_sharded run bit for
    bit, its header is vbx_tpu's string, and the result agrees with
    vbx_tpu's checkpointed mesh run (float64 structured 1e-9; the kernel
    route at the pallas-vs-structured bars of tests/test_pallas.py, run at
    epsilon=1e-3, above the float32 ELBO quantum)."""
    import vbx_tpu_torch.parallel.engine as teng

    kernel = fb_impl is not None
    args, kw = _problem(B=4, T=48, dtype=np.float32 if kernel
                        else np.float64)
    kw = {**kw, "epsilon": 1e-3 if kernel else 1e-9, "fb_impl": fb_impl}
    mesh = tpar.make_mesh(2, 2, device="cpu")
    ref = tpar.vbx_sharded(mesh, *args, **kw)
    ck = str(tmp_path / "vb_state.npz")
    undo = _stop_after(monkeypatch, teng, "vbx_sharded", 1)
    with pytest.raises(KeyboardInterrupt):
        tvb.vbx_batched_checkpointed(*args, **kw, iters_per_slice=4,
                                     checkpoint_path=ck, mesh=mesh)
    undo()
    with np.load(ck) as f:
        assert str(f["fb_impl"]) == want
        assert str(f["dtype"]) == ("float32" if kernel else "float64")
    out = tvb.vbx_batched_checkpointed(*args, **kw, iters_per_slice=4,
                                       checkpoint_path=ck, mesh=mesh)
    assert not os.path.exists(ck)
    _same(out, ref, model_atol=None)
    assert out.alpha.shape == (4, 5, 8)

    j = jvb.vbx_batched_checkpointed(
        *map(jnp.asarray, args), **kw, iters_per_slice=4,
        mesh=jpar.make_mesh(n_dp=2, n_sp=2))
    np.testing.assert_array_equal(_np(out.n_iters), _np(j.n_iters))
    np.testing.assert_allclose(_np(out.elbo), _np(j.elbo),
                               rtol=1e-4 if kernel else 1e-9)
    np.testing.assert_allclose(_np(out.gamma), _np(j.gamma),
                               atol=5e-4 if kernel else 1e-9)
    np.testing.assert_allclose(_np(out.alpha), _np(j.alpha),
                               atol=5e-3 if kernel else 1e-8)
