"""The port's corpus runner (vbx_tpu_torch.cli.run_corpus) and its recipes
against vbx_tpu's recipes/run_corpus.py, on synthetic corpora written by
vbx_tpu_torch.testing, on the CPU: the scenarios of tests/test_recipes.py
(diarization and score stages with their re-entry rule, the score
protocols and the stale-recording filter, the per-stage required flags,
the xvectors stage with a tiny model patched over the checkpoint loader
and its both-outputs re-entry rule) and one run of
recipes/torch_CALLHOME_run.sh.

Bars: RTTMs, all.rttm, score lines, x-vector keys and the segments file
are equal to vbx_tpu's; x-vectors within tests/test_torch_extractor.py's
5e-4 x max (vbx_tpu's features run in float64 here, the port's in
float32).
"""

import importlib.util
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from vbx_tpu.io.ark import iter_vec_ark as j_iter_vec_ark
from vbx_tpu.models import resnet as jr
from vbx_tpu_torch.cli import run_corpus
from vbx_tpu_torch.io.ark import iter_vec_ark
from vbx_tpu_torch.io.segments import read_segments
from vbx_tpu_torch.models import resnet as tr
from vbx_tpu_torch.testing import (host_threads, write_audio_corpus,
                                   write_corpus, write_truth_rttms)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMB_BAR = 5e-4

_spec = importlib.util.spec_from_file_location(
    "vbx_tpu_run_corpus", os.path.join(ROOT, "recipes", "run_corpus.py"))
jrun = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jrun)


# several test workers share the host: keep this file's pools to one thread
@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    with host_threads(1):
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four recordings (seed 3) and their truth RTTMs."""
    d = tmp_path_factory.mktemp("corpus")
    c = write_corpus(str(d / "data"), 3, [260, 410, 180, 330], [2, 4, 3, 3])
    write_truth_rttms(str(d / "refs"), c["truth"])
    lst = d / "list.txt"
    lst.write_text("".join(f"{r}\n" for r in c["truth"]))
    return {**c, "refs": str(d / "refs"), "list": str(lst),
            "names": list(c["truth"])}


def _exp(corpus, path):
    """An experiment directory holding the corpus's x-vector stage output."""
    os.makedirs(path, exist_ok=True)
    shutil.copy(corpus["ark"], os.path.join(path, "xvectors.ark"))
    shutil.copy(corpus["segments"], os.path.join(path, "xvectors.seg"))
    return str(path)


def _argv(corpus, exp, preset="example"):
    return ["--preset", preset, "--list-file", corpus["list"],
            "--exp-dir", exp, "--plda-file", corpus["plda"],
            "--xvec-transform", corpus["transform"]]


def test_diarization_and_score_stages_match_vbx_tpu(corpus, tmp_path,
                                                    capsys):
    exp_t = _exp(corpus, tmp_path / "t")
    exp_j = _exp(corpus, tmp_path / "j")
    argv = ["diarization", "--fb-impl", "structured"]
    assert run_corpus.main(argv + _argv(corpus, exp_t)
                           + ["--device", "cpu"]) == 0
    assert jrun.main(argv + _argv(corpus, exp_j)) == 0
    body = open(os.path.join(exp_t, "all.rttm"), "rb").read()
    assert body == open(os.path.join(exp_j, "all.rttm"), "rb").read()
    assert all(r.encode() in body for r in corpus["names"])
    assert os.path.exists(os.path.join(exp_t, "diarization.jsonl"))

    # idempotent re-entry: a second run skips (all.rttm exists)
    all_rttm = os.path.join(exp_t, "all.rttm")
    mtime = os.stat(all_rttm).st_mtime_ns
    capsys.readouterr()
    assert run_corpus.main(["diarization"] + _argv(corpus, exp_t)
                           + ["--device", "cpu"]) == 0
    assert os.stat(all_rttm).st_mtime_ns == mtime
    assert "skip" in capsys.readouterr().err

    score = ["score", "--ref-rttm-dir", corpus["refs"]]
    assert run_corpus.main(score + _argv(corpus, exp_t)) == 0
    ours = capsys.readouterr().out
    assert jrun.main(score + _argv(corpus, exp_j)) == 0
    assert ours == capsys.readouterr().out
    assert [ln.split(":")[0] for ln in ours.splitlines()] == [
        "forgiving", "fair", "full"]


def _noisy_truth(corpus):
    """The truth labels with every 7th x-vector's speaker moved by one."""
    out = {}
    for rec, z in corpus["truth"].items():
        z = z.copy()
        z[::7] = (z[::7] + 1) % (z.max() + 1)
        out[rec] = z
    return out


def test_score_stage_protocols_and_stale_filtering(corpus, tmp_path,
                                                   capsys):
    """A stale extra recording in all.rttm (from a run over a larger list)
    is filtered out, not scored as pure false alarm; the preset's
    protocols of record are scored (DIHARD2: fair and full only,
    DIHARD2_run.sh:61-62); every line equals vbx_tpu's."""
    sys_dir = tmp_path / "sys"
    write_truth_rttms(str(sys_dir), _noisy_truth(corpus))
    exp = tmp_path / "exp"
    exp.mkdir()
    body = "".join((sys_dir / f"{r}.rttm").read_text()
                   for r in corpus["names"])
    ghost = "SPEAKER GHOST 1 0.00 100.00 <NA> <NA> 1 <NA> <NA>\n"
    argv = ["score", "--list-file", corpus["list"], "--exp-dir", str(exp),
            "--ref-rttm-dir", corpus["refs"]]
    for preset, protocols in (("example", ["forgiving", "fair", "full"]),
                              ("dihard2", ["fair", "full"])):
        outs = []
        for text in (body, body + ghost):
            (exp / "all.rttm").write_text(text)
            assert run_corpus.main(argv + ["--preset", preset]) == 0
            ours = capsys.readouterr().out
            assert jrun.main(argv + ["--preset", preset]) == 0
            assert ours == capsys.readouterr().out
            outs.append(ours)
        assert outs[0] == outs[1]                   # the ghost is filtered
        assert [ln.split(":")[0] for ln in outs[0].splitlines()] == protocols
        assert "DER 0.00" not in outs[0]            # the noise is scored


@pytest.mark.parametrize("stage,flags", [
    ("xvectors", ["--wav-dir", "--lab-dir", "--weights"]),
    ("diarization", ["--plda-file", "--xvec-transform"]),
    ("score", ["--ref-rttm-dir"])])
def test_stage_specific_required_flags(tmp_path, capsys, stage, flags):
    lst = tmp_path / "list.txt"
    lst.write_text("rec\n")
    with pytest.raises(SystemExit) as exc:
        run_corpus.main([stage, "--preset", "example", "--list-file",
                         str(lst), "--exp-dir", str(tmp_path)])
    assert exc.value.code == 2                   # argparse usage error
    err = capsys.readouterr().err
    assert all(f in err for f in flags), err


NB = (1, 1, 1, 1)


def _tiny_models():
    """A narrow ResNet (BasicBlock, 4 base channels; seeded, BatchNorm
    statistics drawn) for the port, and vbx_tpu's model with the same
    weights."""
    torch.manual_seed(0)
    tm = tr.ResNetXVector(tr.BasicBlock, NB, m_channels=4, feat_dim=64,
                          embed_dim=32)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for bn in tm.modules():
            if isinstance(bn, torch.nn.BatchNorm2d):
                bn.weight.uniform_(0.5, 1.5, generator=g)
                bn.running_var.uniform_(0.5, 1.5, generator=g)
    sd = {k: v.float().numpy() for k, v in tm.state_dict().items()}
    params, stats = jr.convert_torch_state_dict(sd, num_blocks=NB)
    fm = jr.ResNetXVector(block=jr.BasicBlock, num_blocks=NB, m_channels=4,
                          feat_dim=64, embed_dim=32)
    return tm, (fm, {**params, **stats})


def test_xvectors_stage_matches_vbx_tpu_and_reenters(tmp_path, monkeypatch,
                                                     capsys):
    """stage_xvectors end to end with a tiny model patched over each
    package's checkpoint loader (the loader is called through its module):
    wav + lab in, ark + seg out, the extractor configuration from the
    preset; keys and segments equal to vbx_tpu's, x-vectors within
    EMB_BAR x max; then the both-outputs re-entry rule."""
    tm, jm = _tiny_models()
    monkeypatch.setattr(tr, "load_torch_checkpoint", lambda path, **kw: tm)
    monkeypatch.setattr(jr, "load_torch_checkpoint", lambda path, **kw: jm)
    audio = tmp_path / "audio"
    names, _, _ = write_audio_corpus(str(audio), 5, [4.0, 6.5])
    lst = tmp_path / "list.txt"
    lst.write_text("".join(f"{n}\n" for n in names))

    def argv(exp):
        return ["xvectors", "--preset", "example", "--list-file", str(lst),
                "--exp-dir", str(exp), "--wav-dir", str(audio),
                "--lab-dir", str(audio), "--weights", "unused.pth"]

    exp, exp_j = tmp_path / "t", tmp_path / "j"
    assert run_corpus.main(argv(exp) + ["--device", "cpu"]) == 0
    assert jrun.main(argv(exp_j)) == 0
    ark, seg = exp / "xvectors.ark", exp / "xvectors.seg"
    assert seg.read_bytes() == (exp_j / "xvectors.seg").read_bytes()
    ours = list(iter_vec_ark(str(ark)))
    ref = list(j_iter_vec_ark(str(exp_j / "xvectors.ark")))
    assert [k for k, _ in ours] == [k for k, _ in ref]
    rows = read_segments(str(seg))
    assert len(rows) == len(ours) > 0 and {r[1] for r in rows} == set(names)
    got = np.stack([v for _, v in ours])
    want = np.stack([v for _, v in ref])
    assert got.shape[1] == 32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=EMB_BAR * np.abs(want).max())

    # re-entry: complete outputs -> skip; a missing seg -> extract again
    mtime = ark.stat().st_mtime_ns
    capsys.readouterr()
    assert run_corpus.main(argv(exp) + ["--device", "cpu"]) == 0
    assert "skip" in capsys.readouterr().err
    assert ark.stat().st_mtime_ns == mtime
    seg_bytes = seg.read_bytes()
    seg.unlink()
    assert run_corpus.main(argv(exp) + ["--device", "cpu"]) == 0
    assert seg.read_bytes() == seg_bytes   # a half-written stage reruns


def test_callhome_recipe_runs_the_diarization_stage(corpus, tmp_path):
    """recipes/torch_CALLHOME_run.sh with --device cpu passed through: the
    preset's paths under MODEL_DIR (plda, transform.h5), the list file,
    and all.rttm byte-equal to the runner called with the same flags."""
    model = tmp_path / "model"
    model.mkdir()
    shutil.copy(corpus["plda"], model / "plda")
    shutil.copy(corpus["transform"], model / "transform.h5")
    exp = _exp(corpus, tmp_path / "exp")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    res = subprocess.run(
        ["bash", os.path.join(ROOT, "recipes", "torch_CALLHOME_run.sh"),
         "diarization", str(tmp_path / "data"), exp, str(model),
         corpus["list"], "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    exp_lib = _exp(corpus, tmp_path / "lib")
    assert run_corpus.main(["diarization"]
                           + _argv(corpus, exp_lib, preset="callhome")
                           + ["--device", "cpu"]) == 0
    body = open(os.path.join(exp, "all.rttm"), "rb").read()
    assert body == open(os.path.join(exp_lib, "all.rttm"), "rb").read()
    assert all(r.encode() in body for r in corpus["names"])
