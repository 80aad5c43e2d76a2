"""The `wavlm_base_plus_sv.extract` cell's files: the cell runs and is
correct on bench_tiny's root (its configuration cut to tiny widths, which
only a test does), its operation count, its two span readers on a
synthetic trace, the seeded weights keeping two windows apart, the plain
reference's window cutting, and (on a card) its control failing the
limit."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import bench_tiny
from bench_tiny import edit, make_root, run_cell
from benchmark import harness
from benchmark.reference import wavlm as ref

CELL = "wavlm_base_plus_sv.extract"
M = harness.load_manifest()
TINY = dict(ref.PUBLISHED, conv_dim=[16] * 7, hidden_size=32,
            num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, tdnn_dim=[16, 16, 16, 16, 40],
            xvector_output_dim=12)
THREADS = "import torch; torch.set_num_threads(4)"


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(harness.BENCH_DIR, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("wavlm"))
    edit(os.path.join(root, "benchmark", "configs", "wavlm_base_plus_sv.json"),
         lambda c: c.update(widths=TINY))
    edit(os.path.join(root, "benchmark", "traffic", "wav_extract.json"),
         lambda t: t.update(batch_size=16))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_and_is_correct_on_the_tiny_root(tiny_root, trace):
    rc, res, err = run_cell(tiny_root, CELL, seed=3000000019, trace=trace,
                            seconds=0.0, extra=THREADS)
    assert rc == 0, err[-3000:]
    assert res["correct"], res
    assert res["attempted"] == 1 and res["failed"] == 0
    assert res["checks"]["segment_rows_wrong"]["value"] == 0
    assert 0 < res["checks"]["xvector_rel_err"]["value"] < 5e-6
    if trace:
        got = res["metrics"]
        assert set(got) == {"wavlm_mfu", "wavlm_frontend_share",
                            "wavlm_encoder_share", "extract_host_share",
                            "device_idle_share.extract"}
        assert 0 < got["wavlm_mfu"]["value"] < 100
        assert 0 < (got["wavlm_frontend_share"]["value"]
                    + got["wavlm_encoder_share"]["value"]) < 100
    else:
        assert set(res["metrics"]) == {"extract_xrt", "setup_s"}


def test_operations_of_a_full_window_and_a_tail():
    flops = _module("wavlm_mfu").wavlm_flops
    assert round(flops(23040, ref.PUBLISHED) / 1e9, 2) == 20.58
    # a tail of 60 frames, 9,600 samples, counted by hand: conv frames
    # 1919, 959, 479, 239, 119, 59, 29; TDNN frames 25, 21, 15, 15, 15
    convs = 512 * (1919 * 10 + 512 * 3 * (959 + 479 + 239 + 119)
                   + 512 * 2 * (59 + 29))
    enc = 29 * (4 * 768 * 768 + 2 * 768 * 3072 + 12 * 64 * 8) \
        + 2 * 12 * 29 * 29 * 64
    head = 29 * 768 * 512 + 512 * (25 * 2560 + 21 * 1536 + 15 * 1536
                                   + 15 * 512) + 15 * 512 * 1500 \
        + 3000 * 512
    macs = convs + 29 * 512 * 768 + 29 * 768 * 48 * 128 + 12 * enc + head
    assert flops(9600, ref.PUBLISHED) == 2 * macs
    read = harness.reader("wavlm_mfu")
    ctx = {"windows": [144, 144, 60], "window_s": 2.0,
           "widths": ref.PUBLISHED}
    assert read(ctx) == pytest.approx(
        100 * (2 * flops(23040, ref.PUBLISHED) + 2 * macs) / 2.0 / 67e12)
    assert read(dict(ctx, windows=[])) is None


class FakeTrace:
    def __init__(self, host_ops, t0=0.0, t1=10e6):
        self.host_ops = list(host_ops)
        self.t0_us, self.t1_us = t0, t1


@pytest.mark.parametrize("metric,span", [
    ("wavlm_frontend_share", "vbx.wavlm.frontend"),
    ("wavlm_encoder_share", "vbx.wavlm.encoder")])
def test_stage_shares_are_the_window_clipped_union(metric, span):
    other = ("vbx.wavlm.encoder" if span == "vbx.wavlm.frontend"
             else "vbx.wavlm.frontend")
    tr = FakeTrace([(-1e6, 1e6, span),           # 1 s inside the window
                    (2e6, 4e6, span), (3e6, 5e6, span),   # 3 s, not 4
                    (5e6, 6e6, other), (6e6, 7e6, "vbx.wavlm.head"),
                    (9.5e6, 12e6, span),        # 0.5 s inside
                    (0.0, 10e6, "bench::window")])
    read = harness.reader(metric)
    assert read({"trace": tr, "window_s": 10.2}) == pytest.approx(45.0)
    assert read({"trace": FakeTrace([(1e6, 2e6, other)]),
                 "window_s": 10.0}) is None
    assert read({"trace": FakeTrace([(11e6, 12e6, span)]),
                 "window_s": 10.0}) is None
    assert read({"trace": None, "window_s": 10.0}) is None


def test_seeded_weights_keep_two_windows_apart():
    """At the published widths: the weight norm's g is |v|, activations
    stay finite, and two windows' embeddings differ by over 100 times
    the cell's limit."""
    from benchmark.extraction_models import wavlm_base_plus_sv as spec

    torch.manual_seed(0)
    state = spec.draw_state(2 ** 31 + 3, ref.PUBLISHED, "cpu")
    assert set(state) == set(ref.param_shapes(ref.PUBLISHED))
    g, v = state[ref.G_V[0][0]], state[ref.G_V[0][1]]
    torch.testing.assert_close(ref.pos_conv_weight(state), v)
    rng = np.random.default_rng(7)
    x = [rng.standard_normal(23040).astype(np.float32) * 0.1
         for _ in range(2)]
    e = ref.embed(ref.Plain(state, ref.PUBLISHED, "cpu"), x, "cpu")
    assert np.isfinite(e).all() and np.abs(e).max() < 1e3
    limit = harness.Cell(M, CELL, 0, 0, False).check["limits"][
        "xvector_rel_err"]
    assert np.linalg.norm(e[0] - e[1]) / np.linalg.norm(e[0]) > 100 * limit


def test_samples_of_cuts_clips_and_tiles():
    pcm = np.arange(100000, dtype=np.float64)
    w = ref.PUBLISHED
    x = ref.samples_of(pcm, (1000, 60000), 24, 144, w)
    np.testing.assert_array_equal(x, (pcm[1000 + 3840:1000 + 3840 + 23040]
                                      / 32768).astype(np.float32))
    x = ref.samples_of(pcm, (1000, 30000), 120, 100, w)   # ends at b
    assert len(x) == 30000 - 1000 - 19200
    x = ref.samples_of(pcm, (99000, 200000), 0, 144, w)   # clipped
    assert len(x) == ref.min_samples(w) == 5200
    np.testing.assert_array_equal(x[1000:2000], x[:1000])  # tiled


@pytest.mark.gpu
def test_the_control_fails_the_limit():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on a CUDA card")
    from benchmark.extraction_models import wavlm_base_plus_sv as spec

    state = spec.draw_state(5, ref.PUBLISHED, "cuda")
    rng = np.random.default_rng(5)
    x = [rng.standard_normal(23040).astype(np.float32) * 0.1
         for _ in range(8)]
    model = ref.Plain(state, ref.PUBLISHED, "cuda")
    base = ref.embed(model, x, "cuda")
    ctl = ref.embed(model, x, "cuda", tf32=True)
    err = max(float(np.linalg.norm(c - b) / np.linalg.norm(b))
              for c, b in zip(ctl, base))
    limit = harness.Cell(M, CELL, 0, 0, False).check["limits"][
        "xvector_rel_err"]
    assert err > 3 * limit


def test_bench_tiny_keeps_the_cell():
    assert CELL in {w["name"] for w in bench_tiny.with_held_out(M)[
        "workloads"]}
