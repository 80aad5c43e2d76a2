"""Each cell's control comes out not correct, at a size a test holds: the
plain reference put in the program's place one precision step below what
the configuration states fails the cell's own limits. The corpus cells
state bfloat16 streams, so the control rounds the reference's streams to
float8 e4m3 (its AHC stays float64); the extraction cell states float32
with TF32 off, so its control runs the reference's ResNet101 with TF32
on, which only a card has. On the card, benchmark/tools/readings.py reads
the controls at the cells' own sizes."""

import json
import os

import numpy as np
import pytest
import torch

import bench_tiny
from benchmark import datagen, harness
from benchmark.drivers import corpus
from benchmark.reference import vbx as ref
from benchmark.reference import xvector as xref

M = bench_tiny.with_held_out(harness.load_manifest())


@pytest.mark.parametrize("workload", ["ami_mixheadset.corpus",
                                      "callhome.corpus"])
def test_corpus_control_fails_the_limits(workload):
    cell = harness.Cell(M, workload, 0, 0, False)
    spec = dict(cell.config["recordings"])
    # AMI's meetings cut to a test's size; CALLHOME's first calls whole
    spec["sizes"] = ([[900, 3], [1100, 4], [700, 2]]
                     if workload.startswith("ami") else spec["sizes"][:12])
    recs = datagen.recordings(spec, 2 ** 31 + 11)
    plda, transform = datagen.synth_models(
        np.random.default_rng([2 ** 31 + 11, 0x50DA]))
    d = cell.config["diarization"]
    st = {"threshold_bias": d["ahc"]["threshold"],
          "init_smoothing": d["ahc"]["init_smoothing"],
          "loop_prob": d["vb"]["loop_prob"], "Fa": d["vb"]["Fa"],
          "Fb": d["vb"]["Fb"], "max_iters": d["vb"]["max_iters"],
          "lda_dim": d["lda_dim"]}
    xs = [r.x for r in recs]
    base = ref.diarize(xs, plda, transform, st)
    ctl = ref.diarize(xs, plda, transform, st, stream=torch.float8_e4m3fn,
                      labels_init=[a for a, _, _ in base])
    lim = cell.check["limits"]
    gaps = [corpus.elbo_gaps(c[2], b[2]) for b, c in zip(base, ctl)]
    first = max(g[0] for g in gaps)
    last = max(g[1] for g in gaps)
    assert (first > lim["elbo_first_gap"]
            or last > lim.get("elbo_last_gap", float("inf")))


@pytest.mark.gpu
def test_extraction_control_fails_the_limit():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on a CUDA card")
    cell = harness.Cell(M, "ami_mixheadset.extract", 0, 0, False)
    rng = np.random.default_rng(5)
    feats = [rng.standard_normal((144, 64)).astype(np.float32)
             for _ in range(16)]
    model = xref.ResNet101()
    model.load_state_dict(datagen.resnet_state(5, model, "cuda"))
    model.to("cuda")
    base = xref.embed(model, feats, "cuda")
    ctl = xref.embed(model, feats, "cuda", tf32=True)
    err = max(float(np.linalg.norm(c - b) / np.linalg.norm(b))
              for c, b in zip(ctl, base))
    assert err > cell.check["limits"]["xvector_rel_err"]
