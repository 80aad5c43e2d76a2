"""The extractor's device dither on the CPU: `dither_ints` against the host
`add_dither(...).astype(np.float32)` bit for bit while its kept noise grows
and is sliced, each (seed, level) on its own sequence, `dither_counters`,
the kept noise under threads, and extract_to_ark's arks and segments files
byte for byte against the host-dithered route (`extract_dithered(
extractor.dither(read_wav(...)))`) for the ResNet and WavLM models, on
16-bit mono, 24-bit, float32 and stereo wavs."""

import dataclasses
import struct
import sys
import threading

import numpy as np
import pytest
import torch

from vbx_tpu_torch.engine import extractor as ex
from vbx_tpu_torch.io.ark import write_vec_ark
from vbx_tpu_torch.io.segments import write_segments
from vbx_tpu_torch.io.vad import read_lab
from vbx_tpu_torch.io.wav import read_wav
from vbx_tpu_torch.models.features import add_dither
from vbx_tpu_torch.models.resnet import Bottleneck, ResNetXVector
from vbx_tpu_torch.testing import synth_audio

from .test_torch_wavlm import _port


def _resnet():
    torch.manual_seed(0)
    return ResNetXVector(Bottleneck, (1, 1, 1, 1), m_channels=8,
                         feat_dim=64, embed_dim=32)


def _extractor(config=None):
    return ex.XVectorExtractor(_resnet(), 16000, config=config, batch_size=8,
                               device="cpu")


def _host(ints, cfg):
    return add_dither(ints.astype(int), cfg.dither_level,
                      cfg.dither_seed).astype(np.float32)


def _same_bits(got: torch.Tensor, want: np.ndarray):
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def _ints(rng, n):
    return rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16)


# lengths that grow, shrink, then grow again past the chunk of a sum
LENGTHS = (1000, 70000, 300, 0, 70000, ex.DITHER_CHUNK + 12345, 5)


def test_device_dither_is_the_host_dither_bit_for_bit():
    e = _extractor()
    rng = np.random.default_rng(0)
    for n in LENGTHS:
        ints = _ints(rng, n)
        _same_bits(e.dither_ints(ints), _host(ints, e.config))
    # integers past full scale (a float wav's) and as int64
    ints = rng.integers(-2 ** 17, 2 ** 17, 5000)
    _same_bits(e.dither_ints(ints), _host(ints, e.config))
    with pytest.raises(TypeError, match="integers"):
        e.dither_ints(np.zeros(4))


@pytest.mark.parametrize("seed,level", [(4, 8.0), (3, 2.5)])
def test_another_seed_or_level_draws_its_own_sequence(seed, level):
    rng = np.random.default_rng(seed)
    ints = _ints(rng, 9000)
    cfg = dataclasses.replace(ex.ExtractorConfig(), dither_seed=seed,
                              dither_level=level)
    own = _extractor(cfg)
    _same_bits(own.dither_ints(ints), _host(ints, cfg))
    # one extractor whose config changes keys its noise anew, both ways
    e = _extractor()
    _same_bits(e.dither_ints(ints), _host(ints, e.config))
    e.config = cfg
    _same_bits(e.dither_ints(ints[:500]), _host(ints[:500], cfg))
    e.config = ex.ExtractorConfig()
    _same_bits(e.dither_ints(ints), _host(ints, e.config))
    assert not np.array_equal(_host(ints, cfg), _host(ints, e.config))


def test_dither_counters_count_a_draw_per_extension_and_none_on_reuse():
    e = _extractor()
    rng = np.random.default_rng(1)
    before = ex.dither_counters()
    draws = drawn = 0
    for n in LENGTHS:
        snap = ex.dither_counters()
        e.dither_ints(_ints(rng, n))
        step = ex.dither_counters(snap)
        grew = max(0, n - drawn)
        assert step == {"files": 1, "samples": n,
                        "noise_draws": int(grew > 0), "noise_samples": grew,
                        "host_int_files": 0}, n
        draws, drawn = draws + (grew > 0), max(drawn, n)
    total = ex.dither_counters(before)
    assert (total["noise_draws"], total["noise_samples"]) == (draws, drawn)
    assert total["samples"] == sum(LENGTHS) and draws == 3
    assert e.dither_noise(10).shape[0] == drawn      # kept, not redrawn
    assert set(before) == {"files", "samples", "noise_draws",
                           "noise_samples", "host_int_files"}


def test_kept_noise_under_threads_is_one_draw_of_the_longest():
    """Threads extend and read the kept noise at once (a serving worker and
    extract_to_ark's reader): every dither stays the host's, and the noise
    kept is one draw of the longest length asked for."""
    e = _extractor()
    rng = np.random.default_rng(2)
    jobs = [[_ints(rng, int(n)) for n in rng.integers(1, 20000, 6)]
            for _ in range(8)]
    bad = []

    def work(batch):
        for ints in batch:
            if not np.array_equal(e.dither_ints(ints).numpy(),
                                  _host(ints, e.config)):
                bad.append(len(ints))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(b,)) for b in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    longest = max(len(i) for b in jobs for i in b)
    kept = e.dither_noise(1).numpy()
    np.testing.assert_array_equal(
        kept, 8.0 * (np.random.RandomState(3).rand(longest) * 2 - 1))


def _write(path, data: np.ndarray, fmt: int, bits: int, fs=16000):
    """A RIFF/WAVE file of `data` ([N] or [N, C]) as stored: PCM (fmt 1)
    of 16 or 24 bits, IEEE float (fmt 3) of 32."""
    ch = 1 if data.ndim == 1 else data.shape[1]
    if bits == 24:
        v = data.astype("<i4").reshape(-1)
        raw = np.stack([(v >> s) & 0xFF for s in (0, 8, 16)],
                       axis=1).astype(np.uint8).tobytes()
    else:
        raw = data.astype({16: "<i2", 32: "<f4"}[bits]).tobytes()
    align = ch * bits // 8
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(raw), b"WAVE"))
        f.write(struct.pack("<4sIHHIIHH", b"fmt ", 16, fmt, ch, fs,
                            fs * align, align, bits))
        f.write(struct.pack("<4sI", b"data", len(raw)) + raw)


def _wav(path, x: np.ndarray, kind: str):
    if kind == "pcm16":
        _write(path, np.rint(x * 32767), 1, 16)
    elif kind == "pcm24":
        _write(path, np.rint(x * (2 ** 23 - 1)), 1, 24)
    elif kind == "float32":           # two samples past full scale
        y = x.copy()
        y[[100, 2000]] = (1.25, -1.5)
        _write(path, y, 3, 32)
    else:                             # 16-bit stereo
        _write(path, np.rint(np.stack([x, 0.5 * x[::-1]], 1) * 32767), 1, 16)


def _host_route_files(ext, wavs, labs, names, ark, seg):
    """The ark and segments of the host-dithered route, as extract_to_ark
    writes them."""
    vecs, rows = [], []
    for wav, lab, name in zip(wavs, labs, names):
        signal, _ = read_wav(wav)
        if signal.ndim > 1:
            signal = signal.mean(axis=1)
        for s in ext.extract_dithered(ext.dither(signal), read_lab(lab),
                                      name):
            vecs.append((s.key, s.xvector))
            rows.append((s.key, name, s.start, s.end))
    write_vec_ark(ark, vecs)
    write_segments(seg, rows)


@pytest.mark.parametrize("kind", ["pcm16", "pcm24", "float32", "stereo"])
@pytest.mark.parametrize("model", ["resnet", "wavlm"])
def test_extract_to_ark_writes_the_host_routes_files(tmp_path, model, kind):
    rng = np.random.default_rng(len(kind))
    names, wavs, labs = [], [], []
    for i, sec in enumerate((7.0, 4.0)):
        x, segs = synth_audio(rng, sec)
        # a 20 ms turn and a 0.2 s one: the short-segment and tail paths
        segs = np.vstack([[[0.05, 0.07], [0.1, 0.3]], segs])
        names.append(f"f{i}")
        wavs.append(str(tmp_path / f"f{i}.wav"))
        labs.append(str(tmp_path / f"f{i}.lab"))
        _wav(wavs[-1], np.clip(x, -0.99, 0.99), kind)
        with open(labs[-1], "w") as f:
            f.writelines(f"{a:.3f} {b:.3f} sp\n" for a, b in segs)
    m = _resnet() if model == "resnet" else _port(seed=4)[0]
    ext = ex.XVectorExtractor(m, 16000, batch_size=8, device="cpu")
    before = ex.dither_counters()
    counts = ex.extract_to_ark(wavs, labs, names, str(tmp_path / "d.ark"),
                               str(tmp_path / "d.seg"), ext)
    got = ex.dither_counters(before)
    assert min(counts.values()) > 0
    assert got["files"] == 2
    assert got["host_int_files"] == (0 if kind == "pcm16" else 2)
    _host_route_files(ext, wavs, labs, names, str(tmp_path / "h.ark"),
                      str(tmp_path / "h.seg"))
    for suffix in ("ark", "seg"):
        assert (tmp_path / f"d.{suffix}").read_bytes() == \
            (tmp_path / f"h.{suffix}").read_bytes(), suffix


def test_extract_file_dithers_on_the_device_as_the_host_does():
    """extract_file (serving, scripts) takes the device dither after the
    host's integers: the same segments as extract_dithered of `dither`."""
    x, segs = synth_audio(np.random.default_rng(5), 5.0)
    e = _extractor()
    before = ex.dither_counters()
    got = e.extract_file(x, segs, "r")
    assert ex.dither_counters(before)["files"] == 1
    want = e.extract_dithered(e.dither(x), segs, "r")
    assert [(s.key, s.start, s.end) for s in got] == \
        [(s.key, s.start, s.end) for s in want]
    np.testing.assert_array_equal(np.stack([s.xvector for s in got]),
                                  np.stack([s.xvector for s in want]))
