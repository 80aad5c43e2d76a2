"""The port's diagnostics (engine.debug, metrics, io.uem, cli.score,
cli.vbhmm, utils.timing) against vbx_tpu's on the same inputs.

The debug oracle runs the same float64 EM in both packages, so its traces
are held at 1e-9 relative; the scorers are host numpy code copied into the
port, so their results are held equal and the CLI's printed text identical.
"""

import dataclasses

import numpy as np
import pytest

from vbx_tpu.cli.score import main as jscore_main
from vbx_tpu.engine.debug import frame_der as jframe_der
from vbx_tpu.engine.debug import vbx_debug as jvbx_debug
from vbx_tpu.metrics import Turn as JTurn
from vbx_tpu.metrics import frame_clustering_metrics as jframe_metrics
from vbx_tpu.metrics import score_corpus as jscore_corpus
from vbx_tpu_torch.cli.score import main as tscore_main
from vbx_tpu_torch.engine.debug import DebugTrace, frame_der, vbx_debug
from vbx_tpu_torch.engine.vbhmm import vbx
from vbx_tpu_torch.io.rttm import RttmSegment, write_rttm_str
from vbx_tpu_torch.io.uem import read_uem, write_uem
from vbx_tpu_torch.metrics import (Turn, der_from_rttm_files,
                                   frame_clustering_metrics, score_corpus)
from vbx_tpu_torch.testing import host_threads

from .oracle import random_vb_problem


# several test workers share the host: keep this file's pools to one thread
@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    with host_threads(1):
        yield


@pytest.mark.parametrize("expected", [True, False])
@pytest.mark.parametrize("xentropy", [True, False])
def test_frame_der_equals_vbx_tpu(expected, xentropy):
    rng = np.random.default_rng(0)
    T, S = 200, 4
    q = rng.dirichlet(np.ones(S), size=T)
    ref = rng.integers(0, 3, T)
    ours = frame_der(q, ref, expected=expected, xentropy=xentropy)
    theirs = jframe_der(q, ref, expected=expected, xentropy=xentropy)
    assert ours == pytest.approx(theirs, rel=1e-12)
    hard = np.zeros((T, S))
    hard[np.arange(T), ref] = 1.0
    assert frame_der(hard, ref, expected=False) == pytest.approx(0.0)


def test_vbx_debug_trace_matches_vbx_tpu_and_the_engine():
    """float64: the per-iteration [ELBO, DER, xent] trace within 1e-9
    relative of vbx_tpu's, the same length, and its ELBO column equal to
    the port engine's own trace."""
    rng = np.random.default_rng(1)
    X, phi, gamma, pi = random_vb_problem(rng, 80, 4, 10)
    kw = dict(loop_prob=0.9, Fa=0.4, Fb=9.0, max_iters=10, epsilon=1e-6)
    res = vbx(X, phi, pi=pi, gamma=gamma, device="cpu", **kw)
    ref_labels = res.gamma.numpy().argmax(1)
    q, pi_out, trace = vbx_debug(X, phi, gamma, pi, ref_labels=ref_labels,
                                 device="cpu", **kw)
    jq, jpi, jtrace = jvbx_debug(X, phi, gamma, pi, ref_labels=ref_labels,
                                 **kw)
    assert len(trace) == len(jtrace) == int(res.n_iters)
    assert all(isinstance(t, DebugTrace) for t in trace)
    for field in ("elbo", "der", "xent"):
        np.testing.assert_allclose([getattr(t, field) for t in trace],
                                   [getattr(t, field) for t in jtrace],
                                   rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose([t.elbo for t in trace],
                               res.elbo.numpy()[:len(trace)], rtol=1e-9)
    assert isinstance(q, np.ndarray) and isinstance(pi_out, np.ndarray)
    np.testing.assert_allclose(q, np.asarray(jq), atol=1e-9)
    np.testing.assert_allclose(pi_out, np.asarray(jpi), atol=1e-9)
    # DER against the engine's own labels converges toward 0
    assert trace[-1].der < trace[0].der + 1e-9
    # no reference labels: the ELBO trace alone
    _, _, bare = vbx_debug(X, phi, gamma, pi, device="cpu", **kw)
    assert [t.elbo for t in bare] == [t.elbo for t in trace]
    assert all(np.isnan(t.der) and np.isnan(t.xent) for t in bare)
    with pytest.raises(ValueError, match="max_iters"):
        vbx_debug(X, phi, gamma, pi, max_iters=0, device="cpu")


def test_vbx_debug_gamma_plot(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(1)
    X, phi, gamma, pi = random_vb_problem(rng, 60, 3, 8)
    ref = rng.integers(0, 3, 60)
    path = tmp_path / "gamma.png"
    _, _, trace = vbx_debug(X, phi, gamma, pi, ref_labels=ref, max_iters=4,
                            plot_path=str(path), device="cpu")
    assert path.stat().st_size > 1000 and len(trace) >= 1


def _random_turns(rng, n, labels):
    out = []
    for _ in range(n):
        s = rng.uniform(0, 20)
        out.append((round(s, 4), round(s + rng.uniform(0.05, 4), 4),
                    f"s{rng.integers(labels)}"))
    return out


def _corpus(seed, n_recordings=4):
    rng = np.random.default_rng(seed)
    ref = {f"rec{r}": _random_turns(rng, 8, 3) for r in range(n_recordings)}
    sys_ = {f"rec{r}": _random_turns(rng, 8, 4) for r in range(n_recordings)}
    return ref, sys_


def _as(cls, corpus):
    return {rec: [cls(*t) for t in turns] for rec, turns in corpus.items()}


@pytest.mark.parametrize("kw", [
    dict(collar=0.0, ignore_overlaps=False),
    dict(collar=0.25, ignore_overlaps=True),
    dict(collar=0.25, ignore_overlaps=False, rasterize=0.01),
    dict(collar=0.0, ignore_overlaps=True,
         uems={f"rec{r}": [(1.0, 9.0), (12.0, 21.0)] for r in range(4)}),
])
def test_score_corpus_and_frame_metrics_equal_vbx_tpu(kw):
    """Seeded random off-grid turn sets: every field of every recording's
    score, the corpus total and every clustering metric are equal."""
    ref, sys_ = _corpus(3)
    per, total = score_corpus(_as(Turn, ref), _as(Turn, sys_), **kw)
    jper, jtotal = jscore_corpus(_as(JTurn, ref), _as(JTurn, sys_), **kw)
    assert sorted(per) == sorted(jper)
    for rec in per:
        assert dataclasses.asdict(per[rec]) == dataclasses.asdict(jper[rec])
    assert dataclasses.asdict(total) == dataclasses.asdict(jtotal)
    assert total.der == jtotal.der and total.jer == jtotal.jer
    uems = kw.get("uems")
    cm = frame_clustering_metrics(_as(Turn, ref), _as(Turn, sys_),
                                  step=0.01, uems=uems)
    jcm = jframe_metrics(_as(JTurn, ref), _as(JTurn, sys_), step=0.01,
                         uems=uems)
    assert cm == jcm and len(cm) >= 9


def _write_rttms(tmp_path, seed):
    ref, sys_ = _corpus(seed)
    paths = []
    for name, corpus in (("ref", ref), ("sys", sys_)):
        p = tmp_path / f"{name}.rttm"
        write_rttm_str(str(p), [RttmSegment(rec, s, e - s, spk)
                                for rec, turns in sorted(corpus.items())
                                for s, e, spk in turns])
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("flags", [
    [], ["--collar", "0.25", "--ignore_overlaps", "--per-recording"],
    ["--rasterize", "--step", "0.02"]])
def test_score_cli_prints_what_vbx_tpu_prints(tmp_path, capsys, flags):
    ref, sys_ = _write_rttms(tmp_path, 5)
    argv = ["-r", ref, "-s", sys_] + flags
    assert tscore_main(argv) == 0
    ours = capsys.readouterr()
    assert jscore_main(argv) == 0
    theirs = capsys.readouterr()
    assert ours.out == theirs.out and ours.err == theirs.err
    assert ours.out.splitlines()[0].startswith("File\tDER\tJER")
    assert ours.out.splitlines()[-1].startswith("*** OVERALL ***")
    # the library call behind the DER column
    _, tot = der_from_rttm_files(ref, sys_)
    if not flags:
        assert f"{tot.der:.2f}" == ours.out.splitlines()[-1].split("\t")[1]


def test_score_cli_uem_and_missing_recordings(tmp_path, capsys):
    ref, sys_ = _write_rttms(tmp_path, 6)
    uem = {f"rec{r}": [(0.0, 10.5), (12.0, 22.0)] for r in range(4)}
    u = tmp_path / "all.uem"
    write_uem(str(u), uem)
    assert read_uem(str(u)) == uem                    # round trip
    argv = ["-r", ref, "-s", sys_, "-u", str(u)]
    assert tscore_main(argv) == 0
    ours = capsys.readouterr()
    assert jscore_main(argv) == 0
    assert ours.out == capsys.readouterr().out
    # a recording absent from an explicit UEM is refused, as dscore does
    write_uem(str(u), {"rec0": [(0.0, 10.0)]})
    assert tscore_main(argv) == 1
    ours = capsys.readouterr()
    assert jscore_main(argv) == 1
    assert ours.err == capsys.readouterr().err
    assert "missing from" in ours.err
    with pytest.raises(ValueError, match="bad UEM line"):
        bad = tmp_path / "bad.uem"
        bad.write_text("rec0 1 0.0\n")
        read_uem(str(bad))


def test_vbhmm_cli_is_the_diarize_cli():
    from vbx_tpu_torch.cli import diarize, vbhmm

    assert vbhmm.main is diarize.main
    assert vbhmm.build_parser is diarize.build_parser
    ns = vbhmm.build_parser().parse_args(
        ["--init", "AHC+VB", "--out-rttm-dir", "o", "--xvec-ark-file", "a",
         "--segments-file", "s", "--xvec-transform", "t", "--plda-file",
         "p", "--device", "cpu"])
    assert ns.device == "cpu"


def test_timer_measures_and_logs(caplog):
    import logging

    from vbx_tpu_torch.utils import Timer

    with caplog.at_level(logging.INFO, logger="vbx_tpu_torch"):
        with Timer("stage") as t:
            pass
    assert t.elapsed >= 0.0
    assert [r.getMessage().split(":")[0] for r in caplog.records] == \
        ["Start", "End"]
    with Timer("quiet", log=False) as q:
        pass
    assert q.elapsed >= 0.0 and len(caplog.records) == 2
