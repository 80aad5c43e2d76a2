"""Each cell's inputs reproduce at a fixed seed, every seed gets the same
sizes, and the frozen copies equal the generators they were copied
from."""

import hashlib
import json
import os

import numpy as np

import bench_tiny
from benchmark import datagen, harness
from benchmark.drivers import extract

M = harness.load_manifest()


def digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def config(name):
    with open(os.path.join(bench_tiny.REPO, "benchmark", "configs",
                           f"{name}.json")) as f:
        return json.load(f)


def test_ami_sizes_are_make_corpus_draws_at_seed_0(tmp_path):
    import sys
    sys.path.insert(0, os.path.join(bench_tiny.REPO, "scripts"))
    from torch_ami_scale_bench import make_corpus

    _, truth = make_corpus(str(tmp_path), n_meetings=3, seed=4,
                           frames=(300, 400))
    drawn = datagen.make_corpus_sizes(n_meetings=3, seed=4,
                                      frames=(300, 400))
    assert [len(z) for z in truth.values()] == [t for t, _ in drawn]
    assert all(z.max() < k for z, (_, k) in zip(truth.values(), drawn))
    sizes = [tuple(s) for s in config("ami_mixheadset")["recordings"]["sizes"]]
    assert sizes == datagen.make_corpus_sizes()
    assert sum(t for t, _ in sizes) == 171509


def test_callhome_sizes_follow_the_published_proportions():
    sizes = config("callhome")["recordings"]["sizes"]
    assert len(sizes) == 128
    assert all(500 <= t <= 1250 for t, _ in sizes)
    counts = np.bincount([k for _, k in sizes], minlength=8)[2:]
    assert counts.tolist() == [78, 35, 11, 3, 1, 0]


def test_recordings_reproduce_and_keep_their_sizes():
    spec = dict(config("callhome")["recordings"])
    spec["sizes"] = spec["sizes"][:12]
    a = datagen.recordings(spec, 2 ** 31 + 5)
    b = datagen.recordings(spec, 2 ** 31 + 5)
    c = datagen.recordings(spec, 17)
    assert digest(*[r.x for r in a]) == digest(*[r.x for r in b])
    assert digest(*[r.x for r in a]) != digest(*[r.x for r in c])
    assert sorted(len(r.x) for r in c) == sorted(len(r.x) for r in a) == sorted(t for t, _ in spec["sizes"])


def test_models_reproduce_and_equal_the_programs_generator(tmp_path):
    from vbx_tpu_torch.testing import synth_models

    (p1, t1), _ = datagen.write_models(str(tmp_path), 7, 128)
    (p2, t2), _ = datagen.write_models(str(tmp_path), 7, 128)
    assert digest(*p1, *t1) == digest(*p2, *t2)
    q, u = synth_models(np.random.default_rng([7, 0x50DA]), lda_dim=128)
    assert digest(*p1, *t1) == digest(*q, *u)


def test_extraction_files_reproduce_with_fixed_lengths_and_vad():
    cell = harness.Cell(M, "ami_mixheadset.extract", 1, 1.0, False)
    cell.traffic["minutes"] = [0.2, 0.3]
    a = extract._files(cell, 99)
    b = extract._files(cell, 99)
    c = extract._files(cell, 100)
    assert digest(*[p for _, p, _ in a]) == digest(*[p for _, p, _ in b])
    key = lambda fs: [(n, len(p), v.tobytes()) for n, p, v in fs]
    assert key(a) == key(c)
    assert digest(*[p for _, p, _ in a]) != digest(*[p for _, p, _ in c])


def test_resnet_weights_reproduce_at_a_fixed_seed():
    from benchmark.reference.xvector import ResNet101

    m = ResNet101(blocks=(1, 1, 1, 1))
    a = datagen.resnet_state(2 ** 33 + 1, m, "cpu")
    b = datagen.resnet_state(2 ** 33 + 1, m, "cpu")
    assert set(a) == set(m.state_dict())
    assert all(bool((a[k] == b[k]).all()) for k in a)
    m.load_state_dict(a)

