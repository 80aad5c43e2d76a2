"""Real multi-process corpus runs of the port on the CPU: two OS processes
of `python -m vbx_tpu_torch.cli.run_corpus` form a gloo process group
(COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID on 127.0.0.1), shard the
recordings over the processes (parallel.distributed.local_recording_slice),
meet at the stage's barrier, and process 0 concatenates. The scenarios of
tests/test_multiprocess.py on synthetic corpora:

- the diarization stage in two processes: all.rttm byte-equal to the
  one-process run and to vbx_tpu's recipes/run_corpus.py;
- the xvectors stage in two processes: ark and segments byte-equal to one
  process (a seeded tiny model patched over the checkpoint loader);
- both processes SIGKILLed after their first RTTM, then the same run
  again: all.rttm byte-identical to an uninterrupted run;

and a peer that dies before the barrier: the other process exits non-zero
at once and writes no all.rttm. Every child has a timeout, and a test
that fails kills its children.
"""

import importlib.util
import os
import shutil
import socket
import subprocess
import sys
import textwrap

import pytest

from vbx_tpu_torch.testing import (host_threads, write_audio_corpus,
                                   write_corpus)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 120


# several test workers share the host: keep this file's pools to one thread
@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    with host_threads(1):
        yield


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES",
                        "PROCESS_ID")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", **extra)
    return env


def _run(cmds_envs):
    """Start every (command, env) at once and wait for all of them, each
    within CHILD_TIMEOUT; kill every child still running if anything
    fails. Returns [(returncode, output)]."""
    procs = []
    try:
        for cmd, env in cmds_envs:
            procs.append(subprocess.Popen(
                cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
        return [(p.returncode, out) for p, out in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _pair(cmd, **extra):
    """The same command in two processes of one group."""
    port = _free_port()
    return _run([(cmd, _env(COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                            NUM_PROCESSES="2", PROCESS_ID=str(pid),
                            **extra)) for pid in (0, 1)])


def _one(cmd, **extra):
    return _run([(cmd, _env(**extra))])


RUNNER = [sys.executable, "-m", "vbx_tpu_torch.cli.run_corpus"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    c = write_corpus(str(d / "data"), 9, [240, 170, 310, 200], [3, 2, 4, 2])
    lst = d / "list.txt"
    lst.write_text("".join(f"{r}\n" for r in c["truth"]))
    return {**c, "list": str(lst), "names": list(c["truth"])}


def _exp(corpus, path):
    os.makedirs(path)
    shutil.copy(corpus["ark"], os.path.join(path, "xvectors.ark"))
    shutil.copy(corpus["segments"], os.path.join(path, "xvectors.seg"))
    return str(path)


def _diarization(corpus, exp):
    return ["diarization", "--preset", "example", "--list-file",
            corpus["list"], "--exp-dir", exp, "--plda-file", corpus["plda"],
            "--xvec-transform", corpus["transform"], "--device", "cpu"]


def _ok(results):
    for pid, (rc, out) in enumerate(results):
        assert rc == 0, f"process {pid} failed:\n{out}"


def test_two_process_corpus_matches_one_process_and_vbx_tpu(corpus,
                                                           tmp_path):
    two = _exp(corpus, tmp_path / "two")
    _ok(_pair(RUNNER + _diarization(corpus, two)))
    # ceil(4 / 2): each process wrote two RTTMs, process 0 concatenated
    assert sorted(os.listdir(os.path.join(two, "rttms"))) == sorted(
        f"{r}.rttm" for r in corpus["names"])
    one = _exp(corpus, tmp_path / "one")
    _ok(_one(RUNNER + _diarization(corpus, one)))
    body = open(os.path.join(two, "all.rttm"), "rb").read()
    assert body == open(os.path.join(one, "all.rttm"), "rb").read()
    assert all(r.encode() in body for r in corpus["names"])

    spec = importlib.util.spec_from_file_location(
        "vbx_tpu_run_corpus_mp", os.path.join(ROOT, "recipes",
                                              "run_corpus.py"))
    jrun = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jrun)
    ref = _exp(corpus, tmp_path / "jax")
    assert jrun.main(_diarization(corpus, ref)[:-2]) == 0
    assert body == open(os.path.join(ref, "all.rttm"), "rb").read()


CHILD_XV = textwrap.dedent("""
    import sys
    import torch
    import vbx_tpu_torch.models.resnet as resnet
    from vbx_tpu_torch.cli import run_corpus

    def tiny_loader(path, **kw):
        # the same seeded weights in every process: the ark bytes of a
        # split run must equal the one-process run's
        torch.manual_seed(0)
        return resnet.ResNetXVector(resnet.BasicBlock, (1, 1, 1, 1),
                                    m_channels=4, feat_dim=64, embed_dim=32)

    resnet.load_torch_checkpoint = tiny_loader
    raise SystemExit(run_corpus.main(sys.argv[1:]))
""")


def test_two_process_xvector_extraction_matches_one_process(tmp_path):
    audio = tmp_path / "audio"
    names, _, _ = write_audio_corpus(str(audio), 21, [3.0, 5.0, 4.0])
    lst = tmp_path / "list.txt"
    lst.write_text("".join(f"{n}\n" for n in names))
    child = tmp_path / "child_xv.py"
    child.write_text(CHILD_XV)

    def cmd(exp):
        return [sys.executable, str(child), "xvectors", "--preset",
                "example", "--list-file", str(lst), "--exp-dir", str(exp),
                "--wav-dir", str(audio), "--lab-dir", str(audio),
                "--weights", "unused.pth", "--device", "cpu"]

    _ok(_pair(cmd(tmp_path / "two")))
    _ok(_one(cmd(tmp_path / "one")))
    for f in ("xvectors.ark", "xvectors.seg"):
        two = (tmp_path / "two" / f).read_bytes()
        assert two == (tmp_path / "one" / f).read_bytes(), f
    # the shards were concatenated and removed
    assert sorted(os.listdir(tmp_path / "two")) == ["xvectors.ark",
                                                    "xvectors.seg"]
    seg = (tmp_path / "two" / "xvectors.seg").read_text()
    assert {ln.split()[1] for ln in seg.splitlines()} == set(names)


CHILD_KILL = textwrap.dedent("""
    import os, signal, sys
    import vbx_tpu_torch.engine.pipeline as pl
    from vbx_tpu_torch.cli import run_corpus

    # SIGKILL this process the moment its Nth RTTM is on disk: a
    # deterministic stand-in for a host lost mid-corpus (only the process
    # named by TEST_KILL_RANK, or every one)
    kill_after = int(os.environ.get("TEST_KILL_AFTER_RTTMS", "0"))
    rank = os.environ.get("TEST_KILL_RANK")
    if kill_after and rank in (None, os.environ.get("PROCESS_ID")):
        real_write = pl.write_rttm
        state = {"n": 0}

        def dying_write(*a, **kw):
            real_write(*a, **kw)
            state["n"] += 1
            if state["n"] >= kill_after:
                os.kill(os.getpid(), signal.SIGKILL)

        pl.write_rttm = dying_write
    raise SystemExit(run_corpus.main(sys.argv[1:]))
""")


def test_two_process_sigkill_midflight_resume_is_exact(corpus, tmp_path):
    """Both processes SIGKILLed right after each writes its first RTTM,
    then the same two-process run again: it resumes the survivors,
    computes the rest, and all.rttm is byte-identical to an uninterrupted
    two-process run."""
    child = tmp_path / "child_kill.py"
    child.write_text(CHILD_KILL)
    cmd = [sys.executable, str(child)]
    ref = _exp(corpus, tmp_path / "ref")
    _ok(_pair(cmd + _diarization(corpus, ref)))
    golden = open(os.path.join(ref, "all.rttm"), "rb").read()

    exp = _exp(corpus, tmp_path / "exp")
    res = _pair(cmd + _diarization(corpus, exp), TEST_KILL_AFTER_RTTMS="1")
    assert all(rc != 0 for rc, _ in res), res           # really died
    assert not os.path.exists(os.path.join(exp, "all.rttm"))
    written = os.listdir(os.path.join(exp, "rttms"))
    assert 0 < len(written) < len(corpus["names"]), written

    _ok(_pair(cmd + _diarization(corpus, exp)))
    assert open(os.path.join(exp, "all.rttm"), "rb").read() == golden


def test_a_peer_that_dies_ends_the_run_without_all_rttm(corpus, tmp_path):
    """Process 1 is SIGKILLed after its first RTTM; process 0 finishes its
    slice, finds the dead peer at the barrier, and exits non-zero at once
    (well within the child timeout, not after the group's long timeout)
    without writing all.rttm."""
    child = tmp_path / "child_kill.py"
    child.write_text(CHILD_KILL)
    exp = _exp(corpus, tmp_path / "exp")
    (rc0, out0), (rc1, _) = _pair(
        [sys.executable, str(child)] + _diarization(corpus, exp),
        TEST_KILL_AFTER_RTTMS="1", TEST_KILL_RANK="1")
    assert rc1 == -9 and rc0 not in (0, None), out0
    assert "barrier 'diarization_rttms_written' failed" in out0
    assert not os.path.exists(os.path.join(exp, "all.rttm"))
