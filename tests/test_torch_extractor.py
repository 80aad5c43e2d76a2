"""The port's extraction path (engine.extractor, cli.extract, cli.predict)
against vbx_tpu's on the same audio, VAD and weights.

Audio is vbx_tpu_torch.testing.synth_audio (harmonic voices over noise,
numpy-seeded), whose VAD ends with a 20 ms segment (the host path for
segments shorter than one analysis window) and a 1.1 s one (a single tail
window). The model is a narrow Bottleneck ResNet [1, 1, 1, 1], 8 base
channels, 32-d, with random weights; vbx_tpu gets the same weights
through its convert_torch_state_dict.

Bars: keys, times and the segments file are equal. vbx_tpu's features run
in float64 here (the test session enables JAX's x64, and its fbank
constants are float64), the port's in float32, so features are held at
tests/test_torch_features.py's float32 fbank bar (1e-3) and embeddings at
tests/test_extractor.py's 5e-4 x max.
"""

import numpy as np
import pytest
import torch

from vbx_tpu.engine import extractor as jex
from vbx_tpu.io.ark import read_vec_ark as j_read_vec_ark
from vbx_tpu.models import resnet as jr
from vbx_tpu_torch.engine import extractor as tex
from vbx_tpu_torch.io.ark import read_vec_ark
from vbx_tpu_torch.models import features as tf
from vbx_tpu_torch.models import resnet as tr
from vbx_tpu_torch.testing import synth_audio, write_audio_corpus

EMB_BAR = 5e-4
FEAT_BAR = 1e-3
NB = (1, 1, 1, 1)


def _port_model(seed=0, dtype=torch.float32):
    torch.manual_seed(seed)
    m = tr.ResNetXVector(tr.Bottleneck, NB, m_channels=8, feat_dim=64,
                         embed_dim=32, dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in m.modules():
            if isinstance(bn, torch.nn.BatchNorm2d):
                bn.weight.uniform_(0.5, 1.5, generator=g)
                bn.running_var.uniform_(0.5, 1.5, generator=g)
    return m


def _jax_extractor(port_model, fs, batch_size=8):
    sd = {k: v.float().numpy() for k, v in port_model.state_dict().items()}
    params, stats = jr.convert_torch_state_dict(sd, num_blocks=NB)
    fm = jr.ResNetXVector(block=jr.Bottleneck, num_blocks=NB, m_channels=8,
                          feat_dim=64, embed_dim=32)
    return jex.XVectorExtractor(fm, {**params, **stats}, fs,
                                batch_size=batch_size)


def _emb_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=EMB_BAR * np.abs(ref).max())


@pytest.mark.parametrize("fs,seconds", [(16000, 9.0), (8000, 6.0)])
def test_extract_file_matches_vbx_tpu(fs, seconds):
    signal, segs = synth_audio(np.random.default_rng(fs), seconds, fs)
    tm = _port_model()
    ours = tex.XVectorExtractor(tm, fs, batch_size=8, device="cpu"
                                ).extract_file(signal.copy(), segs, "rec")
    ref = _jax_extractor(tm, fs).extract_file(signal.copy(), segs, "rec")
    assert [(s.key, s.start, s.end) for s in ours] == \
        [(s.key, s.start, s.end) for s in ref]
    assert ours[-1].key.startswith(f"rec_{len(segs) - 1:04}-00000000-")
    assert len(ours) > 8          # more than one batch, the last padded
    _emb_close(np.stack([s.xvector for s in ours]),
               np.stack([s.xvector for s in ref]))


def test_features_match_vbx_tpus_segment_features():
    """The device path's stream (index mirror, length-sorted groups,
    masked CMVN) row for row against vbx_tpu's host path on each dithered
    segment, the 20 ms one included; seg_len zero rows close the stream."""
    fs = 16000
    signal, segs = synth_audio(np.random.default_rng(2), 12.0, fs)
    ex = tex.XVectorExtractor(_port_model(), fs, device="cpu")
    jx = _jax_extractor(_port_model(), fs)
    feats = ex.features(signal, segs)
    dithered = tf.add_dither((signal * 2 ** 15).astype(int), 8.0, 3)
    labs = (segs * fs).astype(int)
    kept = [s for s in range(len(labs))
            if labs[s, 1] - labs[s, 0] > 0.01 * fs]
    assert [s for s, _, _ in feats.segments] == kept
    stream = feats.stream.numpy()
    for segnum, off, n in feats.segments:
        seg = dithered[labs[segnum, 0]:labs[segnum, 1]]
        ref = np.asarray(jx.segment_features(seg))
        assert ref.shape == (n, 64)
        np.testing.assert_allclose(stream[off:off + n], ref, rtol=0,
                                   atol=FEAT_BAR)
        if len(seg) < ex.winlen:
            np.testing.assert_array_equal(stream[off:off + n],
                                          ex.segment_features(seg).numpy())
    total = sum(n for _, _, n in feats.segments)
    assert stream.shape == (total + 144, 64)
    assert not stream[total:].any()


def test_extract_to_ark_matches_vbx_tpu_and_isolates_a_failed_file(
        tmp_path, capsys):
    fs = 16000
    names, wavs, labs = write_audio_corpus(str(tmp_path), 3, [4.0, 5.0])
    (tmp_path / "bad.wav").write_bytes(b"RIFFgarbage")
    (tmp_path / "bad.lab").write_text("0.10 1.80 sp\n")
    wavs.insert(1, str(tmp_path / "bad.wav"))
    labs.insert(1, str(tmp_path / "bad.lab"))
    names.insert(1, "bad")
    tm = _port_model(1)
    counts = tex.extract_to_ark(
        wavs, labs, names, str(tmp_path / "t.ark"), str(tmp_path / "t.seg"),
        tex.XVectorExtractor(tm, fs, batch_size=8, device="cpu"))
    assert "bad" not in counts and "bad" in capsys.readouterr().err
    j_counts = jex.extract_to_ark(
        wavs, labs, names, str(tmp_path / "j.ark"), str(tmp_path / "j.seg"),
        _jax_extractor(tm, fs))
    assert counts == j_counts and min(counts.values()) > 0
    assert (tmp_path / "t.seg").read_text() == (tmp_path / "j.seg").read_text()
    ours, ref = read_vec_ark(str(tmp_path / "t.ark")), \
        j_read_vec_ark(str(tmp_path / "j.ark"))
    assert list(ours) == list(ref)
    _emb_close(np.stack(list(ours.values())), np.stack(list(ref.values())))
    with pytest.raises(ValueError, match="RIFF"):
        tex.extract_to_ark([wavs[1]], [labs[1]], ["bad"],
                           str(tmp_path / "y.ark"), str(tmp_path / "y.seg"),
                           tex.XVectorExtractor(tm, fs, device="cpu"))


def test_bfloat16_extraction_is_close_to_float32():
    """cosine > 0.999 per x-vector (tests/test_extractor.py's bar)."""
    fs = 16000
    signal, segs = synth_audio(np.random.default_rng(4), 5.0, fs)
    f32 = _port_model(2)
    bf16 = _port_model(2, dtype=torch.bfloat16)
    bf16.load_state_dict(f32.state_dict())
    a, b = (np.stack([s.xvector for s in tex.XVectorExtractor(
        m, fs, batch_size=8, device="cpu").extract_file(signal, segs, "r")])
        for m in (f32, bf16))
    assert np.isfinite(b).all() and a.shape == b.shape
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                            * np.linalg.norm(b, axis=1))
    assert cos.min() > 0.999, cos.min()


def test_extractor_needs_a_card_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.XVectorExtractor(_port_model(), 16000)


@pytest.fixture
def cli_corpus(tmp_path, monkeypatch):
    """Two recordings, a file list, a reference-format .pth and an .onnx
    export of the same weights; vbx_tpu's CLI keeps its compile cache off
    (it would write under HOME)."""
    monkeypatch.setenv("VBX_TPU_COMPILE_CACHE", "off")
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils
    monkeypatch.setattr(onnx_proto_utils, "_add_onnxscript_fn",
                        lambda model_bytes, custom_opsets: model_bytes)
    names, _, _ = write_audio_corpus(str(tmp_path), 5, [6.0, 7.0])
    (tmp_path / "list.txt").write_text("".join(f"{n}\n" for n in names))
    tm = _port_model(3)
    torch.save({f"module.{k}": v for k, v in tm.state_dict().items()},
               tmp_path / "model.pth")
    torch.onnx.export(tm, (torch.randn(1, 64, 24),),
                      str(tmp_path / "model.onnx"), dynamo=False,
                      input_names=["feats"], output_names=["embedding"],
                      dynamic_axes={"feats": {0: "B", 2: "T"}})
    return tmp_path


def _cli_args(d, weights, out, *extra):
    return ["--weights", str(d / weights), "--ndim", "64",
            "--embed-dim", "32", "--in-file-list", str(d / "list.txt"),
            "--in-lab-dir", str(d), "--in-wav-dir", str(d),
            "--out-ark-fn", str(d / f"{out}.ark"),
            "--out-seg-fn", str(d / f"{out}.seg"), "--batch-size", "4",
            *extra]


@pytest.mark.parametrize("backend", ["pytorch", "onnx"])
@pytest.mark.parametrize("cli", ["extract", "predict"])
def test_cli_on_the_cpu_matches_vbx_tpus_cli(cli_corpus, cli, backend):
    """Both CLIs on --device cpu against vbx_tpu's CLI of the same name,
    flags and weights file: the .pth (the CLIs' --model ResNet101 built
    as the narrow test architecture on both sides) and its .onnx export."""
    import importlib

    d = cli_corpus
    port = importlib.import_module(f"vbx_tpu_torch.cli.{cli}")
    ref = importlib.import_module(f"vbx_tpu.cli.{cli}")
    if backend == "pytorch":
        weights, args = "model.pth", []
        port_main = _patch_arch(port.main)
        ref_main = _patch_arch(ref.main, jax_side=True)
    else:
        weights, args = "model.onnx", ["--backend", "onnx"]
        port_main, ref_main = port.main, ref.main
    assert port_main(_cli_args(d, weights, "t", *args, "--device",
                               "cpu")) == 0
    assert ref_main(_cli_args(d, weights, "j", *args)) == 0
    assert (d / "t.seg").read_text() == (d / "j.seg").read_text()
    ours, theirs = read_vec_ark(str(d / "t.ark")), \
        j_read_vec_ark(str(d / "j.ark"))
    assert list(ours) == list(theirs) and len(ours) > 8
    _emb_close(np.stack(list(ours.values())), np.stack(list(theirs.values())))


def test_cli_model_file_takes_precedence_and_depth_is_checked(cli_corpus):
    """--model-file (a whole pickled model) wins over --weights, as in the
    reference; a checkpoint shallower than --model is refused."""
    from vbx_tpu_torch.cli import extract

    d = cli_corpus
    with pytest.raises(ValueError, match="shallower"):
        extract.main(_cli_args(d, "model.pth", "x", "--device", "cpu"))
    tm = tr.ResNetXVector(tr.Bottleneck, NB, 8, 64, 32)
    tm.load_state_dict(_port_model(3).state_dict())
    torch.save(tm, d / "whole.pt")
    run = _patch_arch(extract.main)
    assert run(_cli_args(d, "model.pth", "w", "--device", "cpu")) == 0
    assert run(_cli_args(d, "missing.pth", "m", "--model-file",
                         str(d / "whole.pt"), "--device", "cpu")) == 0
    a, b = read_vec_ark(str(d / "w.ark")), read_vec_ark(str(d / "m.ark"))
    assert list(a) == list(b)
    np.testing.assert_array_equal(np.stack(list(a.values())),
                                  np.stack(list(b.values())))


def test_cli_needs_a_card_unless_given_cpu(cli_corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from vbx_tpu_torch.cli import predict

    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main(_cli_args(cli_corpus, "model.onnx", "x", "--backend",
                               "onnx"))
    assert not (cli_corpus / "x.ark").exists()


def _patch_arch(main, jax_side=False):
    """Run a CLI's main with its ResNet101 factory building the narrow
    test architecture instead (the CLI's --model offers only the
    full-depth families)."""
    import contextlib
    from unittest import mock

    def narrow(feat_dim, embed_dim, dtype=None, **_):
        if jax_side:
            return jr.ResNetXVector(block=jr.Bottleneck, num_blocks=NB,
                                    m_channels=8, feat_dim=feat_dim,
                                    embed_dim=embed_dim)
        return tr.ResNetXVector(tr.Bottleneck, NB, 8, feat_dim, embed_dim,
                                dtype=dtype or torch.float32)

    def run(argv):
        mod = jr if jax_side else tr
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(mod, "resnet101", narrow))
            return main(argv)
    return run
