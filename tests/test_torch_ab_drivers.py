"""The port's A/B drivers (scripts/torch_ab_*.py) against the JAX drivers
they stand for (scripts/ab_{plateau,ahc_device,long_t,sp_blockwise,
s_gt_128,corpus_engine}.py) and vbx_tpu's functions, on the CPU at small
sizes, host pools on one thread.

Tolerances:
- labels of a port run against vbx_tpu's on the same arrays: >= 99.5% of
  each meeting's (or recording's) frames (tests/test_torch_drivers.py's
  AMI bar; a float32 stop iteration is roundoff);
- EM iteration counts: equal, or, where the float32 stop rule fires on
  roundoff (ROADMAP.md §3 "Float32 stop iteration": at |ELBO| ~ 1e3 one
  float32 ulp dwarfs epsilon), within STOP_ITERS of each other, with the
  labels still at the 99.5% bar;
- calibration thresholds within 5e-5 (chip_smoke.py phase 8's bar); walk
  merge distances within 1e-12 of the host chain's;
- float32 EM gamma against vbx_tpu's: structured 2e-5 (the float32
  sequential smoothers' bar of tests/test_torch_smoothers.py), assoc 2e-3
  (its float32 assoc bar at long T);
- a sharded form's ELBO within SP_ELBO_ULPS float32 ulps of |ELBO| of its
  solo engine's (ab_sp_blockwise.py: "within a few f32 ulps").
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbx_tpu_torch.testing import frame_agreement, host_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
AB_DRIVERS = ("torch_ab_corpus_engine", "torch_ab_plateau",
              "torch_ab_ahc_device", "torch_ab_long_t",
              "torch_ab_sp_blockwise", "torch_ab_s_gt_128")
AGREEMENT = 0.995
STOP_ITERS = 4
THR_BAR = 5e-5
DIST_BAR = 1e-12
GAMMA_BARS = {"structured": 2e-5, "assoc": 2e-3}
SP_ELBO_ULPS = 8
F32_EPS = float(np.finfo(np.float32).eps)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_ab_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_tail(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three meetings of 300-600 frames (torch_ami_scale_bench.make_corpus,
    byte-equal to the JAX generator's) and the synthetic models."""
    d = str(tmp_path_factory.mktemp("ab_corpus"))
    ami = _load("torch_ami_scale_bench")
    ami.make_corpus(d, n_meetings=3, frames=(300, 600))
    ami.write_models(d)
    return d


def _jax_plateau_batch(metas):
    """scripts/ab_plateau.py:64-79, the JAX driver's recipe verbatim."""
    T_pad = max(1 << (m[1].shape[0] - 1).bit_length() for m in metas)
    S_pad = max(1 << (m[3].shape[1] - 1).bit_length() for m in metas)
    B, D = len(metas), metas[0][1].shape[1]
    X = np.zeros((B, T_pad, D), np.float32)
    G = np.zeros((B, T_pad, S_pad), np.float32)
    PI = np.zeros((B, S_pad), np.float32)
    FM = np.zeros((B, T_pad), bool)
    SM = np.zeros((B, S_pad), bool)
    for b, (rec, fea, phi, qinit) in enumerate(metas):
        T, S = qinit.shape
        X[b, :T] = fea
        G[b, :T, :S] = qinit
        PI[b, :S] = 1.0 / S
        FM[b, :T] = True
        SM[b, :S] = True
    return X, G, PI, FM, SM, metas[0][2]


def _jax_metas(d):
    """ab_plateau.py's host init chain on vbx_tpu, on `d`'s files."""
    from vbx_tpu.config import get_preset
    from vbx_tpu.engine.pipeline import Diarizer
    from vbx_tpu.io.ark import group_by_recording, iter_vec_ark

    diar = Diarizer.from_files(get_preset("ami_mixheadset"), f"{d}/plda",
                               f"{d}/transform.h5")
    metas = []
    for rec, _, x_raw in group_by_recording(iter_vec_ark(f"{d}/c.ark")):
        x = diar.transform_xvectors(x_raw)
        labels = diar.initial_labels(x)
        fea, phi, qinit = diar.vb_inputs(x, labels)
        metas.append((rec, fea, phi, qinit))
    return metas


def _hold_iters_and_labels(it_mine, it_ref, lab_mine, lab_ref, FM):
    for b in range(len(FM)):
        assert abs(int(it_mine[b]) - int(it_ref[b])) <= STOP_ITERS, b
        agree = frame_agreement(lab_ref[b][FM[b]], lab_mine[b][FM[b]])
        assert agree >= AGREEMENT, (b, agree)


def test_plateau_batch_and_rows_match_the_jax_driver(corpus, capsys):
    """ab_plateau.py on three meetings: the port's padded batch is
    bit-equal to the JAX recipe's on vbx_tpu's host init chain, and both
    stop rules on the CPU's structured route give vbx_tpu's vbx_batched
    labels (>= 99.5% a meeting) within the float32 stop-iteration rule;
    main() prints the JAX driver's three lines and its JSON line."""
    from vbx_tpu.engine.vbhmm import vbx_batched as jax_vbx_batched

    drv = _load("torch_ab_plateau")
    cfg = drv.ami.preset()
    with host_threads(1):
        metas = drv.vb_metas(corpus, cfg, "cpu")
        batch = drv.padded_batch(metas)
        ref_batch = _jax_plateau_batch(_jax_metas(corpus))
        for mine, ref in zip(batch, ref_batch):
            assert mine.dtype == ref.dtype
            np.testing.assert_array_equal(mine, ref)
        X, G, PI, FM, SM, phi = batch
        for ulps in (0.0, cfg.vb.plateau_ulps):
            _, it, lab, _ = drv.run_rule(batch, cfg, "structured", ulps,
                                         "cpu", 1)
            r = jax_vbx_batched(
                jnp.asarray(X), jnp.asarray(phi, jnp.float32),
                jnp.asarray(G), jnp.asarray(PI), jnp.asarray(FM),
                jnp.asarray(SM), loop_prob=cfg.vb.loop_prob, Fa=cfg.vb.Fa,
                Fb=cfg.vb.Fb, max_iters=cfg.vb.max_iters,
                epsilon=cfg.vb.epsilon, fb_impl="structured",
                plateau_ulps=ulps, plateau_iters=cfg.vb.plateau_iters)
            _hold_iters_and_labels(it, np.asarray(r.n_iters), lab,
                                   np.asarray(r.gamma).argmax(-1), FM)
        assert drv.main(["structured", "3", "--frames", "300", "600",
                         "--reps", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("plateau OFF (reference rule): iters=[")
    assert lines[1].startswith("plateau ON  (4.0 ulps/2): iters=[")
    assert lines[2].startswith("batch steps: ")
    line = json.loads(lines[-1])
    assert line["meetings"] == 3 and line["device"] == "cpu"
    assert line["shape"] == [3, 1024, int(batch[1].shape[2])]


def test_ahc_device_parts_match_vbx_tpu_and_the_host(monkeypatch, capsys):
    """ab_ahc_device.py at N = 1200, D = 16: the port's streamed sweep on
    the CPU within 5e-5 of vbx_tpu's (XLA:CPU) and of the host sweep; the
    walk's twin gives vbx_tpu's host-chain merge pairs with distances
    within 1e-12; ahc_labels 'device' (the CUDA predicate patched, the
    blocked cutoff lowered so N = 1200 takes the long route, the walk
    then its plain twin) equals 'host'; main() exits 0."""
    from vbx_tpu.clustering import linkage_dot_avg as jax_linkage
    from vbx_tpu.engine import ahc as jahc
    from vbx_tpu.ops.calibration import \
        two_gmm_calib_cosine_device as jax_calib
    from vbx_tpu_torch.clustering import device as tdev
    from vbx_tpu_torch.engine import ahc as tahc
    from vbx_tpu_torch.ops.calibration import two_gmm_calib_cosine_device

    drv = _load("torch_ab_ahc_device")
    xn = drv.unit_rows(1200, 16)
    with host_threads(1):
        thr = two_gmm_calib_cosine_device(xn, device="cpu")
        _, thr_host = tahc._blocked_cosine_condensed_and_thr(
            xn, want_condensed=False)
        assert abs(thr - float(jax_calib(xn))) <= THR_BAR
        assert abs(thr - thr_host) <= THR_BAR
        _, jthr_host = jahc._blocked_cosine_condensed_and_thr(
            xn, want_condensed=False)
        assert abs(thr_host - jthr_host) <= THR_BAR

        Zd = tdev.linkage_dot_avg_device(xn, device="cpu")
        Zj = jax_linkage(xn)
        np.testing.assert_array_equal(Zd[:, :2], Zj[:, :2])
        np.testing.assert_allclose(Zd[:, 2], Zj[:, 2], rtol=0,
                                   atol=DIST_BAR)
        np.testing.assert_array_equal(drv.cut(Zd, thr_host),
                                      drv.cut(Zj, thr_host))

        monkeypatch.setattr(tahc, "_on_cuda", lambda device: True)
        monkeypatch.setattr(tahc, "_BLOCKED_MIN_N", 1024)
        calls = []
        real = tdev.linkage_dot_avg_device
        monkeypatch.setattr(tdev, "linkage_dot_avg_device",
                            lambda x, device=None: (calls.append(len(x)),
                                                    real(x, device))[1])
        row = drv.front_half(xn, 1200, "cpu")
        assert row["same"] and calls == [1200]
        assert drv.main(["1200", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0].startswith("calibration N=1200: device ")
    assert "merge pairs equal: True" in lines[1]
    assert "labels at the calibrated cut identical: True" in lines[1]
    assert lines[2].startswith("ahc_labels N=1200: ") and \
        "labels identical: True" in lines[2]
    line = _json_tail(out)
    assert line["linkage"]["dist_err"] <= DIST_BAR
    assert line["calibration"]["thr_err"] <= THR_BAR


@pytest.mark.parametrize("impl", ["structured", "assoc"])
def test_long_t_rows_match_vbx_tpus_vbx(impl):
    """ab_long_t.py's rows at T = 256, S = 4, 3 iterations on its seed's
    inputs: the port's vbx against vbx_tpu's vbx, gamma at the float32
    smoother bars."""
    from vbx_tpu.engine.vbhmm import vbx as jax_vbx

    drv = _load("torch_ab_long_t")
    _, X, phi, G, PI = drv.inputs(256, 4)
    with host_threads(1):
        mine = drv.run(impl, tuple(torch.as_tensor(a)
                                   for a in (X, phi, G, PI)), 3, "cpu")
    ref = jax_vbx(jnp.asarray(X), jnp.asarray(phi), pi=jnp.asarray(PI),
                  gamma=jnp.asarray(G), max_iters=3, fb_impl=impl,
                  **drv.HP)
    assert mine.gamma.dtype == torch.float32
    np.testing.assert_allclose(mine.gamma.numpy(), np.asarray(ref.gamma),
                               rtol=0, atol=GAMMA_BARS[impl])


def test_long_t_driver_runs_on_the_cpu(capsys):
    with host_threads(1):
        assert _load("torch_ab_long_t").main(
            ["256", "4", "3", "--reps", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == "calib matmul 4096^3: not measured (--device cpu)"
    assert lines[1].startswith("gamma maxdiff structured vs assoc: ")
    assert lines[2].startswith("gamma maxdiff vs float64 structured: ")
    assert lines[3].startswith("structured: median ") and \
        lines[4].startswith("assoc: median ")
    line = _json_tail(out)
    assert line["gamma_maxdiff"] <= GAMMA_BARS["assoc"]
    for impl, err in line["gamma_maxdiff_vs_float64"].items():
        assert err <= GAMMA_BARS[impl], (impl, err)


def test_sp_forms_match_their_solo_engines_and_vbx_tpu(monkeypatch,
                                                        capsys):
    """ab_sp_blockwise.py on a 1 x 2 CPU mesh, T = 512: every sp form's
    labels equal its matching solo engine's, its ELBO within a few float32
    ulps of |ELBO|; sp_structured against vbx_tpu's vbx_sharded on a 1 x 2
    mesh of the XLA CPU devices at the float32 structured bar; main()
    exits 0 with the JAX driver's lines."""
    from vbx_tpu.parallel import make_mesh as jax_make_mesh
    from vbx_tpu.parallel import vbx_sharded as jax_vbx_sharded
    from vbx_tpu_torch.parallel.mesh import make_mesh

    drv = _load("torch_ab_sp_blockwise")
    arrays = drv.inputs(512, 8)
    mesh = make_mesh(n_dp=1, n_sp=2, device="cpu")
    with host_threads(1):
        run = drv.runner(mesh, tuple(torch.as_tensor(a) for a in arrays),
                         10)
        res = {f: run(f) for f in (*drv.FORMS, "solo_structured")}
    for form, (solo, _) in drv.PARITY.items():
        p = drv.parity(res[solo], res[form])
        assert p["agreement"] == 1.0, (form, p)
        assert p["elbo_maxdiff"] <= SP_ELBO_ULPS * F32_EPS * p["elbo_abs"], \
            (form, p)
    jmesh = jax_make_mesh(n_dp=1, n_sp=2, devices=jax.devices()[:2])
    ref = jax_vbx_sharded(jmesh, *(jnp.asarray(a) for a in arrays),
                          loop_prob=0.9, Fa=0.3, Fb=17.0, max_iters=10,
                          epsilon=-1.0)
    g = res["sp_structured"].gamma.numpy()
    np.testing.assert_allclose(g, np.asarray(ref.gamma), rtol=0,
                               atol=GAMMA_BARS["structured"])
    assert np.array_equal(g.argmax(-1), np.asarray(ref.gamma).argmax(-1))

    monkeypatch.setenv("SCALING_DEVICES", "2")
    with host_threads(1):
        assert drv.main(["512", "--reps", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == [
        "gamma maxdiff solo_pallas_bf16 vs sp_pallas_bf16",
        "gamma maxdiff solo_pallas vs sp_pallas",
        "gamma maxdiff solo_structured vs sp_structured"]
    assert [ln.split(":")[0] for ln in lines[3:8]] == list(drv.FORMS)
    line = _json_tail(out)
    assert line["mesh"] == [1, 2] and line["repeated"]


def test_s_gt_128_agreement_line_against_vbx_tpu(capsys):
    """ab_s_gt_128.py at T = 64, B = 2, S = 160 on its generator: the
    port's kernel route (its plain twin here) and structured route agree
    with vbx_tpu's structured run on the same inputs (>= 99.5% of frames);
    main() exits 0 and prints the agreement line."""
    from vbx_tpu.engine.vbhmm import vbx_batched as jax_vbx_batched

    drv = _load("torch_ab_s_gt_128")
    arrays = drv.make(np.random.default_rng(0), 160, 64, 2)
    ref = jax_vbx_batched(*(jnp.asarray(a) for a in arrays), max_iters=5,
                          fb_impl="structured", **drv.HP)
    lab_ref = np.asarray(ref.gamma[0]).argmax(-1)
    with host_threads(1):
        for fb in ("pallas_bf16", "structured"):
            r = drv.run(arrays, fb, 5, "cpu")
            agree = float(np.mean(r.gamma[0].argmax(-1).numpy() == lab_ref))
            assert agree >= AGREEMENT, (fb, agree)
        assert drv.main(["64", "2", "--reps", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln]
    assert [ln.split(":")[0] for ln in lines[:5]] == [
        f"S={S:4d} fb_impl={fb:12s}" for S, fb in drv.ROWS]
    assert lines[-2].startswith("S=160 pallas vs structured label "
                                "agreement: ")
    line = _json_tail(out)
    assert line["s160_agreement"] >= AGREEMENT


def test_corpus_engine_matches_the_oracle_recipe_and_vbx_tpu(corpus,
                                                             capsys):
    """ab_corpus_engine.py: the port's corpus_fingerprint equals
    gen_ami_ref_labels.corpus_fingerprint (loaded by path) on the same
    ark; on the three-meeting corpus the None and 'structured' rows agree
    with vbx_tpu's diarize_ark on the same files on >= 99.5% of every
    meeting's frames; main() on two meetings exits 0 with bounds=OK on all
    four rows."""
    from vbx_tpu.config import get_preset as jax_preset
    from vbx_tpu.engine.pipeline import diarize_ark as jax_diarize_ark

    drv = _load("torch_ab_corpus_engine")
    cfg = drv.ami.preset()
    hp = drv.hyperparameters(cfg)
    gen = _load("gen_ami_ref_labels")
    assert drv.corpus_fingerprint(f"{corpus}/c.ark", hp) == \
        gen.corpus_fingerprint(f"{corpus}/c.ark", hp)
    jcfg = jax_preset("ami_mixheadset")
    assert hp == dict(Fa=jcfg.vb.Fa, Fb=jcfg.vb.Fb, loopP=jcfg.vb.loop_prob,
                      threshold=jcfg.ahc.threshold,
                      smoothing=jcfg.ahc.init_smoothing)
    with host_threads(1):
        ref = jax_diarize_ark(f"{corpus}/c.ark", f"{corpus}/c.seg",
                              f"{corpus}/jrttm", jcfg, f"{corpus}/plda",
                              f"{corpus}/transform.h5", verbose=False,
                              fb_impl=None)
        for fb in (None, "structured"):
            outs, _, _, failures = drv.run_row(corpus, cfg, fb, "cpu")
            assert not failures and sorted(outs) == sorted(ref)
            for m in outs:
                assert frame_agreement(ref[m].labels1st,
                                       outs[m].labels1st) >= AGREEMENT, \
                    (fb, m)
        assert drv.main(["2", "--frames", "300", "600",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    rows = out.splitlines()[:4]
    assert [r.split()[0] for r in rows] == ["None", "structured", "pallas",
                                            "pallas_bf16"]
    assert all(r.endswith("bounds=OK") for r in rows), rows
    line = _json_tail(out)
    assert line["fingerprint"] is None and len(line["rows"]) == 4


@pytest.mark.parametrize("driver", AB_DRIVERS)
def test_ab_driver_needs_a_card_unless_given_cpu(driver, capsys):
    """With no card and no --device cpu an A/B driver's main() returns
    non-zero, naming --device cpu, with nothing on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    assert _load(driver).main([]) != 0
    cap = capsys.readouterr()
    assert "--device cpu" in cap.err and cap.out == ""
