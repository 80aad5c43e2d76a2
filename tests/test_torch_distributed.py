"""The port's multi-host pieces (vbx_tpu_torch.parallel.distributed and
diarize_ark(shard_over_hosts=)) against vbx_tpu's, in one process on the
CPU: the single-process no-op, the recording slice of every process for
corpus sizes 0-20 and 1-5 processes (the process index and count patched
in both packages), configurations that cannot form a group, the one-process
shard run byte-equal to an unsharded one, the second of two processes'
slice, and the mesh rule with vbx_tpu's words. tests/test_torch_
multiprocess.py runs real process groups."""

import filecmp
import os

import jax
import pytest

from vbx_tpu.config import get_preset as jpreset
from vbx_tpu.engine import pipeline as jpipe
from vbx_tpu.parallel import distributed as jdist
from vbx_tpu.parallel.mesh import make_mesh as j_make_mesh
from vbx_tpu_torch.config import get_preset as tpreset
from vbx_tpu_torch.engine import pipeline as tpipe
from vbx_tpu_torch.parallel import distributed as tdist
from vbx_tpu_torch.parallel import make_mesh
from vbx_tpu_torch.testing import host_threads, write_corpus

ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


# several test workers share the host: keep this file's pools to one thread
@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    with host_threads(1):
        yield


@pytest.fixture(autouse=True)
def _no_cluster_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


def test_single_process_noop():
    tdist.initialize()           # no env, no args: must not raise
    assert not tdist.dist.is_initialized()
    assert (tdist.process_index(), tdist.process_count()) == (0, 1)
    assert tdist.local_recording_slice(10) == slice(0, 10)
    tdist.barrier("alone")       # a no-op in one process


def _patch_processes(monkeypatch, index, count):
    monkeypatch.setattr(jax, "process_index", lambda: index)
    monkeypatch.setattr(jax, "process_count", lambda: count)
    monkeypatch.setattr(tdist, "process_index", lambda: index)
    monkeypatch.setattr(tdist, "process_count", lambda: count)


@pytest.mark.parametrize("count", [1, 2, 3, 4, 5])
def test_local_recording_slice_matches_vbx_tpu(monkeypatch, count):
    for n_rec in range(21):
        covered = []
        for index in range(count):
            _patch_processes(monkeypatch, index, count)
            sl = tdist.local_recording_slice(n_rec)
            assert sl == jdist.local_recording_slice(n_rec), (n_rec, index)
            covered += list(range(n_rec))[sl]
        assert covered == list(range(n_rec))   # each recording once


@pytest.mark.parametrize("env,kw", [
    ({"NUM_PROCESSES": "2"}, {}),
    ({"NUM_PROCESSES": "2", "PROCESS_ID": "0"}, {}),
    ({"PROCESS_ID": "1"}, {}),
    ({}, {"num_processes": 2, "process_id": 0}),
    ({"COORDINATOR_ADDRESS": "127.0.0.1:1"}, {}),
    ({"COORDINATOR_ADDRESS": "127.0.0.1:1", "NUM_PROCESSES": "2",
      "PROCESS_ID": "2"}, {}),
    ({"COORDINATOR_ADDRESS": "127.0.0.1:1", "NUM_PROCESSES": "2"},
     {"process_id": -1}),
])
def test_a_configuration_that_cannot_form_a_group_raises(monkeypatch, env,
                                                         kw):
    """A count or rank without a coordinator, a coordinator without them,
    or a rank out of range raises before any connection is attempted: the
    process never carries on as a single-process run."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError):
        tdist.initialize(**kw)
    assert not tdist.dist.is_initialized()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("corpus")), 5,
                        [220, 300, 160, 260, 190], [2, 3, 2, 4, 3])


def _run(corpus, out, **kw):
    return tpipe.diarize_ark(corpus["ark"], corpus["segments"], str(out),
                             tpreset("example"), corpus["plda"],
                             corpus["transform"], verbose=False,
                             device="cpu", **kw)


def test_shard_over_hosts_in_one_process_is_the_whole_run(corpus, tmp_path):
    a = _run(corpus, tmp_path / "all")
    b = _run(corpus, tmp_path / "sharded", shard_over_hosts=True)
    assert sorted(a) == sorted(b) == sorted(corpus["truth"])
    names = sorted(os.listdir(tmp_path / "all"))
    assert names == sorted(os.listdir(tmp_path / "sharded"))
    for f in names:
        assert filecmp.cmp(tmp_path / "all" / f, tmp_path / "sharded" / f,
                           shallow=False), f


def test_the_second_of_two_processes_writes_its_slice(corpus, tmp_path,
                                                      monkeypatch):
    """Process 1 of 2 owns recordings 3-4 of 5 (ceil(5 / 2) = 3 a
    process): it writes only their RTTMs, byte-equal to the whole run's,
    and so does vbx_tpu's diarize_ark under the same patch."""
    whole = tmp_path / "whole"
    _run(corpus, whole)
    _patch_processes(monkeypatch, 1, 2)
    out = _run(corpus, tmp_path / "p1", shard_over_hosts=True)
    jpipe.diarize_ark(corpus["ark"], corpus["segments"], str(tmp_path / "j"),
                      jpreset("example"), corpus["plda"],
                      corpus["transform"], verbose=False,
                      shard_over_hosts=True)
    want = sorted(corpus["truth"])[3:]
    assert sorted(out) == want
    for d in ("p1", "j"):
        assert sorted(os.listdir(tmp_path / d)) == [f"{r}.rttm"
                                                    for r in want]
        for r in want:
            assert filecmp.cmp(tmp_path / d / f"{r}.rttm",
                               whole / f"{r}.rttm", shallow=False), (d, r)


def test_a_mesh_with_several_processes_raises_vbx_tpus_words(
        corpus, tmp_path, monkeypatch):
    _patch_processes(monkeypatch, 0, 2)
    with pytest.raises(ValueError) as jexc:
        jpipe.diarize_ark(corpus["ark"], corpus["segments"],
                          str(tmp_path / "j"), jpreset("example"),
                          corpus["plda"], corpus["transform"],
                          verbose=False, mesh=j_make_mesh(n_dp=2, n_sp=1))
    with pytest.raises(ValueError) as texc:
        _run(corpus, tmp_path / "t", mesh=make_mesh(2, 1, device="cpu"))
    want = (str(jexc.value).replace("jax.process_count()", "process_count()")
            .replace("jax.local_devices()", "the local devices"))
    assert str(texc.value) == want
    assert not os.listdir(tmp_path / "t")
