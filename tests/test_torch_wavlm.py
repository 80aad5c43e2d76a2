"""WavLM Base Plus SV in the port (`models/wavlm.py`, the extractor's
raw-waveform stream, `cli/extract.py --model WavLMBasePlusSV`) on the CPU
at tiny widths and seeded weights: the plain reference (tests/wavlm_plain.py)
against Hugging Face's `WavLMForXVector`, the port against the plain
reference on full, tail and tiled windows, the bucket table, the state
dict's names at the published widths, the checkpoint loader's two weight
norm layouts, the segments rows against the fbank path's, the CLI end to
end, and the stage spans and counters."""

import functools
import gzip
import json
import os

import numpy as np
import pytest
import torch

from vbx_tpu_torch.engine.extractor import XVectorExtractor, extract_to_ark
from vbx_tpu_torch.io.ark import read_vec_ark
from vbx_tpu_torch.io.wav import read_wav, write_wav
from vbx_tpu_torch.models import wavlm
from vbx_tpu_torch.models.resnet import Bottleneck, ResNetXVector
from vbx_tpu_torch.testing import synth_audio
from vbx_tpu_torch.utils import profiling

from . import wavlm_plain as plain

TINY = dict(plain.PUBLISHED, conv_dim=[16] * 7, hidden_size=32,
            num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, tdnn_dim=[16, 16, 16, 16, 40],
            xvector_output_dim=12)
FULL = 23040
REL = 2e-5   # float32 rounding through two tiny layers, summed over orders


def _draw(w, seed=0):
    """A state dict at Hugging Face's names (weight norm as original0/1):
    He conv weights, 1/fan_in matrices, O(1) norms, gate constants,
    bucket embeddings and layer weights, small biases; g = |v| + noise."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, s in plain.param_shapes(w).items():
        z = torch.randn(s, generator=g)
        fan = float(np.prod(s[1:])) if len(s) > 1 else 1.0
        if k.startswith("wavlm.feature_extractor.") and k.endswith(
                "conv.weight"):
            z = z * (2.0 / fan) ** 0.5
        elif k.endswith("rel_attn_embed.weight") or k == "layer_weights":
            pass
        elif (k.endswith("weight") or k.endswith("original1")) and len(s) > 1:
            z = z / fan ** 0.5
        elif k.endswith("weight") or k.endswith("const"):
            z = 1.0 + 0.1 * z
        elif k.endswith("bias"):
            z = 0.1 * z
        sd[k] = z
    gk, vk = plain.G_V[0]
    v = sd[vk]
    sd[gk] = torch.sqrt((v * v).sum((0, 1), keepdim=True)) * (
        1.0 + 0.1 * torch.randn(sd[gk].shape, generator=g))
    return sd


def _port(w=TINY, seed=0):
    sd = _draw(w, seed)
    m = wavlm.WavLMXVector(wavlm.WavLMWidths.from_dict(w))
    m.load_state_dict(wavlm.convert_wavlm_state_dict(sd, m))
    return m, sd


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.linalg.norm(a - b, axis=-1)
                        / np.linalg.norm(b, axis=-1)))


def _windows(seed, lengths):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((0.1 * rng.standard_normal(n)).astype(
        np.float32)) for n in lengths]


def test_plain_reference_matches_hugging_face(monkeypatch):
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    cfg = transformers.WavLMConfig(use_weighted_layer_sum=True, **TINY)
    hf = transformers.WavLMForXVector(cfg).eval()
    sd = _draw(TINY, 1)
    full = dict(hf.state_dict())
    full.update(sd)
    hf.load_state_dict(full)
    xs = _windows(1, [FULL, FULL, 9600, 5200])
    with torch.no_grad():
        got = torch.stack([plain.forward(sd, TINY, x) for x in xs])
        want = torch.cat([hf(x[None]).embeddings for x in xs])
    assert _rel(got, want) <= 1e-5


def test_port_matches_plain_on_full_windows():
    m, sd = _port(seed=2)
    xs = _windows(2, [FULL] * 3)
    with torch.inference_mode():
        got = m(torch.stack(xs))
        want = torch.stack([plain.forward(sd, TINY, x) for x in xs])
    assert _rel(got, want) <= REL


def test_masked_batch_rows_equal_their_lone_runs():
    """A batch of a full window, two tails and a window tiled up to
    min_samples (as the extractor cuts it), padded with other samples:
    each row equals the port's lone unpadded run and the plain model's."""
    m, sd = _port(seed=3)
    assert m.min_samples == wavlm.min_samples(wavlm.WavLMWidths.from_dict(
        TINY)) == 5200
    short = _windows(4, [1700])[0]
    xs = _windows(3, [FULL, 17600, 9600]) + [short[np.arange(5200) % 1700]]
    batch = torch.full((4, FULL), 0.7)
    for i, x in enumerate(xs):
        batch[i, :len(x)] = x
    lengths = torch.tensor([len(x) for x in xs])
    with torch.inference_mode():
        got = m(batch, lengths)
        alone = torch.cat([m(x[None]) for x in xs])
        want = torch.stack([plain.forward(sd, TINY, x) for x in xs])
    assert torch.isfinite(got).all()
    assert _rel(got, alone) <= REL
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("t", [71, 200])
def test_bucket_table(t):
    got = wavlm.relative_buckets(t, 320, 800, "cpu")
    assert torch.equal(got, plain.buckets(t, 320, 800))
    assert wavlm.relative_buckets(t, 320, 800, "cpu") is got   # kept
    # exact below 80 a side, keys after the query in the upper half,
    # log-spaced up to 800, capped at 159
    assert got[10, 10] == 0 and got[10, 11] == 161 and got[11, 10] == 1
    assert got[0, 70] == 230 and got[70, 0] == 70
    if t > 160:
        assert got[0, 79] == 239 and got[0, 80] == 240
        # 80 + floor(log(199 / 80) / log(10) * 80) = 111
        assert got[0, 199] == 271 and got[199, 0] == 111


def test_state_dict_names_and_shapes_at_the_published_widths(monkeypatch):
    monkeypatch.setenv("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    cfg = transformers.WavLMConfig(use_weighted_layer_sum=True)
    with torch.device("meta"):
        hf = transformers.WavLMForXVector(cfg)
    want = {k: tuple(v.shape) for k, v in hf.state_dict().items()
            if not k.startswith(("classifier.", "objective."))
            and k != "wavlm.masked_spec_embed"}
    assert want == {k: tuple(s) for k, s in
                    plain.param_shapes(plain.PUBLISHED).items()}
    g, v = plain.G_V[0]
    want[f"{plain.POS}.weight"] = want.pop(v)
    del want[g]
    with torch.device("meta"):
        port = wavlm.WavLMXVector()
    assert {k: tuple(t.shape) for k, t in port.state_dict().items()} == want
    # Hugging Face's 100,228,697 less the weight norm's g, folded
    assert sum(t.numel() for t in port.parameters()) == 100_228_569


@pytest.mark.parametrize("layout", [0, 1])
def test_load_checkpoint_in_both_weight_norm_layouts(tmp_path, layout):
    sd = _draw(TINY, 5)
    g, v = sd.pop(plain.G_V[0][0]), sd.pop(plain.G_V[0][1])
    gk, vk = plain.G_V[layout]
    sd.update({gk: g, vk: v, "classifier.weight": torch.zeros(12, 12),
               "objective.weight": torch.zeros(12, 2),
               "wavlm.masked_spec_embed": torch.zeros(32)})
    path = str(tmp_path / "pytorch_model.bin")
    torch.save(sd, path)
    m = wavlm.load_wavlm_checkpoint(path, wavlm.WavLMWidths.from_dict(TINY))
    torch.testing.assert_close(
        m.wavlm.encoder.pos_conv_embed.conv.weight,
        g * v / v.norm(dim=(0, 1), keepdim=True), rtol=1e-6, atol=1e-7)
    x = _windows(5, [FULL])[0]
    with torch.inference_mode():
        assert _rel(m(x[None])[0], plain.forward(sd, TINY, x)) <= REL
    bad = dict(sd, **{"wavlm.extra.weight": torch.zeros(1)})
    torch.save(bad, path)
    with pytest.raises(ValueError, match="unexpected"):
        wavlm.load_wavlm_checkpoint(path, wavlm.WavLMWidths.from_dict(TINY))
    del sd["projector.bias"]
    torch.save(sd, path)
    with pytest.raises(ValueError, match="missing"):
        wavlm.load_wavlm_checkpoint(path, wavlm.WavLMWidths.from_dict(TINY))


def _spans(log_dir):
    """The `user_annotation` names of the one trace under `log_dir`."""
    (path,) = log_dir.glob("*.pt.trace.json.gz")
    with gzip.open(path, "rt") as f:
        return [e["name"] for e in json.load(f)["traceEvents"]
                if e.get("cat") == "user_annotation"]


def _audio(d, seed=3):
    """Two wavs whose VAD holds a 0.2 s turn (one 20-frame tail window of
    3,200 samples, tiled) and a 20 ms one, besides synth_audio's turns."""
    rng = np.random.default_rng(seed)
    names, wavs, labs = [], [], []
    for i, sec in enumerate((12.0, 9.0)):
        sig, segs = synth_audio(rng, sec)
        segs = np.vstack([[[0.05, 0.07], [0.1, 0.3]], segs])
        names.append(f"w{i}")
        wavs.append(os.path.join(d, f"w{i}.wav"))
        labs.append(os.path.join(d, f"w{i}.lab"))
        write_wav(wavs[-1], sig, 16000)
        with open(labs[-1], "w") as f:
            f.writelines(f"{a:.3f} {b:.3f} sp\n" for a, b in segs)
    return names, wavs, labs


def test_extractor_rows_equal_the_fbank_paths_and_each_window_its_plain_run(
        tmp_path):
    names, wavs, labs = _audio(str(tmp_path))
    m, sd = _port(seed=6)
    ext = XVectorExtractor(m, 16000, batch_size=8, device="cpu")
    assert ext.input_kind == "waveform"
    before = wavlm.counters()
    extract_to_ark(wavs, labs, names, str(tmp_path / "w.ark"),
                   str(tmp_path / "w.seg"), ext)
    counts = wavlm.counters(before)
    torch.manual_seed(0)
    res = ResNetXVector(Bottleneck, (1, 1, 1, 1), m_channels=8, feat_dim=64,
                        embed_dim=32)
    extract_to_ark(wavs, labs, names, str(tmp_path / "r.ark"),
                   str(tmp_path / "r.seg"),
                   XVectorExtractor(res, 16000, batch_size=8, device="cpu"))
    rows = (tmp_path / "w.seg").read_text()
    assert rows == (tmp_path / "r.seg").read_text()
    arks = read_vec_ark(str(tmp_path / "w.ark"))
    assert list(arks) == [r.split()[0] for r in rows.splitlines()]
    tails = tiled = 0
    for name, wav, lab in zip(names, wavs, labs):
        sig, _ = read_wav(wav)
        dith = ext.dither(sig)
        vad = (np.loadtxt(lab, usecols=(0, 1)) * 16000).astype(int)
        for key, vec in arks.items():
            if not key.startswith(name + "_"):
                continue
            seg, s0, s1 = map(int, key.rsplit("_", 1)[1].split("-"))
            a, b = vad[seg, 0], min(vad[seg, 1], len(dith))
            x = (dith[a + 160 * s0:min(a + 160 * s1, b)] / 32768).astype(
                np.float32)
            tails += len(x) < FULL
            if len(x) < 5200:
                tiled += 1
                x = x[np.arange(5200) % len(x)]
            want = plain.forward(sd, TINY, torch.from_numpy(x)).numpy()
            assert _rel(vec, want) <= REL, key
    assert tiled == 2
    assert (counts["windows"], counts["masked_windows"],
            counts["tiled_windows"]) == (len(arks), tails, tiled)
    assert counts["batches"] * 8 == len(arks) + counts["pad_slots"]
    assert counts["samples"] > FULL * (len(arks) - tails)
    assert 0 < counts["pad_slots"] < 16


def test_a_file_in_several_chunks_gives_the_same_ark(tmp_path, monkeypatch):
    """WAVE_CHUNK batches at a time: a file of more batches runs its
    stages chunk by chunk, each chunk's spans once, with the same
    embeddings."""
    from vbx_tpu_torch.engine import extractor

    names, wavs, labs = _audio(str(tmp_path), seed=10)
    m, _ = _port(seed=10)
    ext = XVectorExtractor(m, 16000, batch_size=4, device="cpu")
    extract_to_ark(wavs[:1], labs[:1], names[:1], str(tmp_path / "a.ark"),
                   str(tmp_path / "a.seg"), ext)
    monkeypatch.setattr(extractor, "WAVE_CHUNK", 2)
    before = wavlm.counters()
    with profiling.trace(str(tmp_path / "trace")):
        extract_to_ark(wavs[:1], labs[:1], names[:1],
                       str(tmp_path / "b.ark"), str(tmp_path / "b.seg"), ext)
    chunks = -(-wavlm.counters(before)["batches"] // 2)
    assert chunks > 2
    spans = _spans(tmp_path / "trace")
    assert spans.count("vbx.wavlm.head") == chunks
    a, b = (read_vec_ark(str(tmp_path / f"{t}.ark")) for t in "ab")
    assert list(a) == list(b)
    np.testing.assert_allclose(np.stack(list(b.values())),
                               np.stack(list(a.values())), rtol=1e-5,
                               atol=1e-6)


def test_cli_runs_wavlm_on_a_tiny_checkpoint(tmp_path, monkeypatch):
    from vbx_tpu_torch.cli import extract

    names, _, _ = _audio(str(tmp_path), seed=8)
    (tmp_path / "list.txt").write_text("".join(f"{n}\n" for n in names))
    torch.save(_draw(TINY, 8), tmp_path / "pytorch_model.bin")
    monkeypatch.setattr(wavlm, "load_wavlm_checkpoint", functools.partial(
        wavlm.load_wavlm_checkpoint,
        widths=wavlm.WavLMWidths.from_dict(TINY)))

    def args(*extra):
        return ["--model", "WavLMBasePlusSV", "--weights",
                str(tmp_path / "pytorch_model.bin"), "--in-file-list",
                str(tmp_path / "list.txt"), "--in-lab-dir", str(tmp_path),
                "--in-wav-dir", str(tmp_path), "--out-ark-fn",
                str(tmp_path / "x.ark"), "--out-seg-fn",
                str(tmp_path / "x.seg"), "--batch-size", "4", "--device",
                "cpu", *extra]

    with pytest.raises(SystemExit, match="embed-dim 256"):
        extract.main(args())
    with pytest.raises(SystemExit, match="onnx"):
        extract.main(args("--embed-dim", "12", "--backend", "onnx"))
    with pytest.raises(SystemExit, match="bfloat16"):
        extract.main(args("--embed-dim", "12", "--dtype", "bfloat16"))
    assert extract.main(args("--embed-dim", "12")) == 0
    arks = read_vec_ark(str(tmp_path / "x.ark"))
    assert len(arks) > 8
    assert {v.shape for v in arks.values()} == {(12,)}
    assert len((tmp_path / "x.seg").read_text().splitlines()) == len(arks)


def test_the_three_stage_spans_appear_once_a_file(tmp_path):
    names, wavs, labs = _audio(str(tmp_path), seed=9)
    m, _ = _port(seed=9)
    ext = XVectorExtractor(m, 16000, batch_size=8, device="cpu")
    with profiling.trace(str(tmp_path / "trace")):
        extract_to_ark(wavs, labs, names, str(tmp_path / "x.ark"),
                       str(tmp_path / "x.seg"), ext)
    spans = _spans(tmp_path / "trace")
    for span in ("vbx.wavlm.frontend", "vbx.wavlm.encoder",
                 "vbx.wavlm.head", "vbx.extract.features",
                 "vbx.extract.embed"):
        assert spans.count(span) == len(names), span
    for span in ("vbx.extract.load_wait", "vbx.extract.write"):
        assert span in spans


def test_counters_take_a_snapshot_and_deltas():
    before = wavlm.counters()
    wavlm.add_counts(windows=3, pad_slots=1)
    assert wavlm.counters(before) == dict(dict.fromkeys(before, 0),
                                          windows=3, pad_slots=1)
    assert set(before) == {"windows", "masked_windows", "tiled_windows",
                           "samples", "batches", "pad_slots"}
