"""The port's HDF5 codec (vbx_tpu_torch.io.hdf5), which reads transform.h5
on every machine and writes it, against h5py and vbx_tpu's reader; and the
extraction codecs (wav, VAD labels, Kaldi matrix arks) against vbx_tpu's,
bit for bit."""

import os
import sys

import h5py
import numpy as np
import pytest

from vbx_tpu.io import kaldi_matrix as j_km, vad as j_vad, wav as j_wav
from vbx_tpu.io.transform import read_xvec_transform as jax_read
from vbx_tpu_torch.io import hdf5
from vbx_tpu_torch.io import kaldi_matrix as t_km, vad as t_vad, wav as t_wav
from vbx_tpu_torch.io.transform import read_xvec_transform as torch_read

from .util import REF


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {"mean1": rng.standard_normal(256),
            "lda": rng.standard_normal((256, 128)),
            "mean2": rng.standard_normal(128)}


def test_h5py_reads_what_the_codec_writes(tmp_path):
    arrs = _arrays(0)
    extra = {"f32": np.arange(6, dtype=np.float32).reshape(2, 3),
             "i32": np.arange(-2, 3, dtype=np.int32)}
    path = str(tmp_path / "t.h5")
    hdf5.write_datasets(path, {**arrs, **extra})
    with h5py.File(path, "r") as f:
        assert sorted(f) == sorted({**arrs, **extra})
        for k, v in {**arrs, **extra}.items():
            assert f[k].dtype == v.dtype
            np.testing.assert_array_equal(f[k][()], v)
    for a, b in zip(jax_read(path), (arrs[k] for k in ("mean1", "lda",
                                                       "mean2"))):
        np.testing.assert_array_equal(a, b)


def test_codec_reads_what_h5py_writes(tmp_path):
    arrs = _arrays(1)
    path = str(tmp_path / "t.h5")
    with h5py.File(path, "w") as f:
        for k, v in arrs.items():
            f[k] = v
        f["be"] = np.arange(4, dtype=">f4")
    got = hdf5.read_datasets(path)
    for k, v in arrs.items():
        np.testing.assert_array_equal(got[k], v)
    np.testing.assert_array_equal(got["be"], np.arange(4, dtype=np.float32))
    with h5py.File(path, "a") as f:        # grow the group past one node
        for i in range(12):
            f[f"x{i:02d}"] = np.full(3, float(i))
    got = hdf5.read_datasets(path)
    assert len(got) == 4 + 12
    np.testing.assert_array_equal(got["x11"], np.full(3, 11.0))


def test_transform_reader_without_h5py(tmp_path, monkeypatch):
    """The port's transform reader needs no h5py (the CUDA machine has
    none) and returns what vbx_tpu's h5py reader returns."""
    arrs = _arrays(2)
    path = str(tmp_path / "t.h5")
    hdf5.write_datasets(path, arrs)
    with_h5py = jax_read(path)
    monkeypatch.setitem(sys.modules, "h5py", None)    # import h5py fails
    without = torch_read(path)
    for a, b, k in zip(with_h5py, without, ("mean1", "lda", "mean2")):
        assert b.dtype == np.float64
        np.testing.assert_array_equal(a, arrs[k])
        np.testing.assert_array_equal(b, arrs[k])
    with pytest.raises(ValueError, match="HDF5"):
        (tmp_path / "bad.h5").write_bytes(b"not hdf5 at all")
        hdf5.read_datasets(str(tmp_path / "bad.h5"))


# h5py writer settings the reader covers, and those it refuses by name
@pytest.mark.parametrize("variant,file_kw,ds_kw,refused", [
    ("default", {}, {}, None),
    ("attributes", {}, {}, None),
    ("float32", {}, {"dtype": "f4"}, None),
    ("user_block", {"userblock_size": 512}, {}, None),
    ("libver_latest", {"libver": "latest"}, {}, "superblock version"),
    ("track_order", {"track_order": True}, {}, "object headers"),
    ("gzip", {}, {"compression": "gzip"}, "chunked"),
])
def test_transform_reader_on_h5py_layouts(tmp_path, variant, file_kw, ds_kw,
                                          refused):
    arrs = _arrays(3)
    path = str(tmp_path / f"{variant}.h5")
    with h5py.File(path, "w", **file_kw) as f:
        for k, v in arrs.items():
            d = f.create_dataset(k, data=v, **ds_kw)
            if variant == "attributes":
                d.attrs["note"] = "x"
                f.attrs["version"] = np.arange(3)
    if refused:
        with pytest.raises(ValueError, match=refused):
            torch_read(path)
        return
    for a, b in zip(torch_read(path), jax_read(path)):
        np.testing.assert_array_equal(a, b)


TRANSFORM_ASSET = f"{REF}/VBx/models/ResNet101_16kHz/transform.h5"


@pytest.mark.skipif(not os.path.exists(TRANSFORM_ASSET),
                    reason="reference model assets not mounted")
def test_transform_reader_on_the_vbx_asset():
    """The VBx model's own transform.h5: the port's reader and vbx_tpu's
    h5py reader return the same arrays."""
    for a, b in zip(torch_read(TRANSFORM_ASSET), jax_read(TRANSFORM_ASSET)):
        np.testing.assert_array_equal(a, b)


# -- the extraction codecs: wav, VAD labels, Kaldi matrix arks --------------

@pytest.mark.parametrize("kind", ["u8", "i16", "i24", "i32", "f32", "f64",
                                  "i16_stereo", "ours"])
def test_wav_reader_is_vbx_tpus(tmp_path, kind):
    """Every PCM width and IEEE float, mono and stereo, read bit for bit as
    vbx_tpu reads it; write_wav's bytes are vbx_tpu's."""
    from scipy.io import wavfile

    rng = np.random.default_rng(len(kind))
    x = rng.uniform(-0.9, 0.9, 4001)
    path = str(tmp_path / "a.wav")
    if kind == "ours":
        t_wav.write_wav(path, x, 8000)
        j_wav.write_wav(str(tmp_path / "b.wav"), x, 8000)
        assert open(path, "rb").read() == \
            open(str(tmp_path / "b.wav"), "rb").read()
    elif kind == "i24":
        ints = np.round(x * 2 ** 23).astype("<i4")
        raw = np.stack([(ints >> s) & 0xFF for s in (0, 8, 16)],
                       axis=1).astype(np.uint8).tobytes()
        import struct
        with open(path, "wb") as f:
            f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(raw), b"WAVE"))
            f.write(struct.pack("<4sIHHIIHH", b"fmt ", 16, 1, 1, 16000,
                                48000, 3, 24))
            f.write(struct.pack("<4sI", b"data", len(raw)) + raw)
    else:
        data = {"u8": np.round(x * 127 + 128).astype(np.uint8),
                "i16": np.round(x * 32767).astype(np.int16),
                "i32": np.round(x * 2 ** 31 * 0.99).astype(np.int32),
                "f32": x.astype(np.float32), "f64": x,
                "i16_stereo": np.round(np.stack([x, -x], 1)
                                       * 32767).astype(np.int16)}[kind]
        wavfile.write(path, 16000, data)
    got, ref = t_wav.read_wav(path), j_wav.read_wav(path)
    assert got[1] == ref[1]
    assert got[0].dtype == ref[0].dtype == np.float64
    np.testing.assert_array_equal(got[0], ref[0])


def test_vad_labels_are_vbx_tpus(tmp_path):
    path = tmp_path / "a.lab"
    path.write_text("0.10 2.805 sp\n\n3.5 4.0\n4.25  7.3333 speech x\n")
    got, ref = t_vad.read_lab(str(path)), j_vad.read_lab(str(path))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (3, 2)
    for fs in (8000, 16000):
        np.testing.assert_array_equal(t_vad.lab_to_sample_ranges(got, fs),
                                      j_vad.lab_to_sample_ranges(ref, fs))
    empty = tmp_path / "e.lab"
    empty.write_text("")
    assert t_vad.read_lab(str(empty)).shape == (0, 2)


def _sparse_record(rows, dim):
    import struct

    out = b"SM \x04" + struct.pack("<i", len(rows))
    for row in rows:
        out += b"SV \x04" + struct.pack("<i", dim) + b"\x04" + \
            struct.pack("<i", len(row))
        for idx, val in row:
            out += b"\x04" + struct.pack("<i", idx) + b"\x04" + \
                struct.pack("<f", val)
    return out


@pytest.mark.parametrize("compression", [None, 1, 2, 3])
def test_matrix_ark_is_vbx_tpus(tmp_path, compression):
    """Dense (float32, float64) and compressed (CM, CM2, CM3) matrix arks:
    the writer's bytes and the reader's arrays equal vbx_tpu's; a sparse
    matrix reads as vbx_tpu reads it, dense and as CSR."""
    rng = np.random.default_rng(7)
    mats = [("uttA", rng.standard_normal((37, 13)).astype(np.float32)),
            ("uttB", 3.0 * rng.standard_normal((5, 13))),
            ("uttC", np.full((4, 2), 0.25, np.float32))]
    ours, theirs = str(tmp_path / "t.ark"), str(tmp_path / "j.ark")
    t_km.write_mat_ark(ours, mats, compression=compression)
    j_km.write_mat_ark(theirs, mats, compression=compression)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    got, ref = t_km.read_mat_ark(ours), j_km.read_mat_ark(ours)
    assert list(got) == list(ref) == ["uttA", "uttB", "uttC"]
    for k in got:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])

    sparse = str(tmp_path / "s.ark")
    rows = [[(0, 1.5), (4, -2.0)], [], [(2, 0.25)]]
    with open(sparse, "wb") as f:
        f.write(b"utt1 \x00B" + _sparse_record(rows, 6))
    got = dict(t_km.iter_mat_ark(sparse))["utt1"]
    np.testing.assert_array_equal(got, j_km.read_mat_ark(sparse)["utt1"])
    assert got.shape == (3, 6) and got[0, 4] == -2.0
    with open(sparse, "rb") as f:
        f.read(len(b"utt1 \x00B"))
        csr = t_km.read_sparse_mat(f)
    with open(sparse, "rb") as f:
        f.read(len(b"utt1 \x00B"))
        j_csr = j_km.read_sparse_mat(f)
    np.testing.assert_array_equal(csr.toarray(), j_csr.toarray())
    with open(sparse, "rb") as f:
        f.read(len(b"utt1 \x00B"))
        np.testing.assert_array_equal(t_km.read_mat_binary(f), got)
