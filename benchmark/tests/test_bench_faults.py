"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (benchmark/run.py's main with the card
check skipped, on the CPU, at bench_tiny's sizes and the cells' own
limits) with one fault planted in the program, and sees `correct` false;
the same run without a fault comes out correct. The faults a cell can
have: a step that returns its state unchanged (the VB EM), half of the
batch left out (recordings of a pass; x-vectors of a ResNet batch, the
mean of the rest in their place), an answer altered where it is produced
(the top-1 labels; one x-vector of each batch). No cell spans cards, so
no exchange between chips can be left out.
"""

import pytest

from bench_tiny import make_root, run_cell

CORPUS_FAULTS = {
    "state_unchanged": """
import vbx_tpu_torch.engine.vbhmm as v
def broken(step, state, max_iters):
    step(state, 0)
    return state
v._run_em = broken
""",
    "half_batch_left_out": """
import vbx_tpu_torch.engine.pipeline as p
orig = p._diarize_batched
def broken(diar, recs, *a, **k):
    out = orig(diar, recs, *a, **k)
    return {r: out[r] for r in sorted(out)[:(len(out) + 1) // 2]}
p._diarize_batched = broken
""",
    "answer_altered": """
import vbx_tpu_torch.engine.pipeline as p
orig = p._top2
def broken(g, m):
    l1, l2 = orig(g, m)
    l1 = l1.clone()
    l1[:, ::2] = 0
    return l1, l2
p._top2 = broken
""",
}

EXTRACT_FAULTS = {
    "half_batch_left_out": """
from vbx_tpu_torch.engine.extractor import XVectorExtractor as X
orig = X.embed_batch
def broken(self, stream, starts, lengths=None):
    e = orig(self, stream, starts, lengths).clone()
    h = e.shape[0] // 2
    e[h:] = e[:h].mean(0)
    return e
X.embed_batch = broken
""",
    "answer_altered": """
from vbx_tpu_torch.engine.extractor import XVectorExtractor as X
orig = X.embed_batch
def broken(self, stream, starts, lengths=None):
    e = orig(self, stream, starts, lengths).clone()
    e[0] *= 1.01
    return e
X.embed_batch = broken
""",
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("workload", ["ami_mixheadset.corpus",
                                      "callhome.corpus",
                                      "ami_mixheadset.extract"])
def test_sound_run_is_correct(root, workload):
    rc, res, err = run_cell(root, workload)
    assert rc == 0, err[-3000:]
    assert res["correct"], res


@pytest.mark.parametrize("workload", ["ami_mixheadset.corpus",
                                      "callhome.corpus"])
@pytest.mark.parametrize("fault", sorted(CORPUS_FAULTS))
def test_corpus_fault_is_not_correct(root, workload, fault):
    rc, res, err = run_cell(root, workload, extra=CORPUS_FAULTS[fault])
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res


@pytest.mark.parametrize("fault", sorted(EXTRACT_FAULTS))
def test_extract_fault_is_not_correct(root, fault):
    rc, res, err = run_cell(root, "ami_mixheadset.extract",
                            extra=EXTRACT_FAULTS[fault])
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res
