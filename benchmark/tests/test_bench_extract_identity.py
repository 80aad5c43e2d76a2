"""The extraction driver runs `ami_mixheadset.extract` as it did before
its model came from benchmark/extraction_models/: on bench_tiny's root,
one call of the first recording (a window of 0 s closes after one call),
the compared numbers, every segments row, the seed-drawn sample and the
reference's features and embeddings equal, bit for bit, what the driver
with ResNet101 built by hand read (extract_identity.json, recorded from
that driver with the same capture on this test's CPU, torch on 4 threads).
"""

import json
import os

import pytest

from bench_tiny import make_root, run_cell

HERE = os.path.dirname(os.path.abspath(__file__))
RECORDED = os.path.join(HERE, "extract_identity.json")
SEEDS = (3000000019,)

# Planted before the run: records what the driver reads back and what it
# hands the reference, through the module attributes it calls.
CAPTURE = """
import atexit, hashlib, json
import numpy as np
import torch
torch.set_num_threads(4)
from benchmark import harness, kaldi_io
from benchmark.reference import xvector as _x
_rec = {{"segments": [], "sample": None, "features": [], "embeddings": []}}
def _digest(arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()
_read = kaldi_io.read_segments
def read_segments(path):
    rows = _read(path)
    _rec["segments"].append([list(r) for r in rows])
    return rows
kaldi_io.read_segments = read_segments
_sample = harness.sample
def sample(seed, population, k):
    out = _sample(seed, population, k)
    _rec["sample"] = [list(x) for x in out]
    return out
harness.sample = sample
_embed = _x.embed
def embed(model, feats, device, tf32=False):
    out = _embed(model, feats, device, tf32)
    _rec["features"].append(_digest(feats))
    _rec["embeddings"].append(_digest([out]))
    return out
_x.embed = embed
atexit.register(lambda: json.dump(_rec, open({out!r}, "w")))
"""


def capture(root, seed):
    """The driver's reads of one `ami_mixheadset.extract` call at `seed`
    on the tiny copy at `root`: the result's compared numbers and counts,
    and what CAPTURE recorded."""
    out = os.path.join(root, f"capture_{seed}.json")
    rc, res, err = run_cell(root, "ami_mixheadset.extract", seed=seed,
                            seconds=0.0, extra=CAPTURE.format(out=out))
    assert rc == 0, err[-3000:]
    with open(out) as f:
        got = json.load(f)
    got.update(correct=res["correct"], attempted=res["attempted"],
               failed=res["failed"], checks=res["checks"])
    return got


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("identity"))


@pytest.mark.parametrize("seed", SEEDS)
def test_extract_reads_what_it_read_with_resnet101_by_hand(root, seed):
    with open(RECORDED) as f:
        want = json.load(f)[str(seed)]
    got = capture(root, seed)
    assert got["attempted"] == 1 and got["correct"]
    for key in ("checks", "failed", "segments", "sample", "features",
                "embeddings"):
        assert got[key] == want[key], key
