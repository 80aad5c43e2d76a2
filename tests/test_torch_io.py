"""The port's HDF5 codec (vbx_tpu_torch.io.hdf5), which reads transform.h5
on every machine and writes it, against h5py and vbx_tpu's reader; the
extraction codecs (wav, VAD labels, Kaldi matrix arks) against vbx_tpu's,
bit for bit; and the bulk readers of vector arks and segments files against
vbx_tpu's stream readers, bit for bit and error for error; and the
segments reader against vbx_tpu's."""

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


# -- vector arks and segments: the bulk readers against vbx_tpu's streams ----

def _vec_record(key, vec, typ=b"FV ", dim=None):
    """One ark record's bytes; `dim` overrides the stored dim."""
    dim = len(vec) if dim is None else dim
    return (key.encode() + b" \x00B" + typ + b"\x04"
            + np.int32(dim).tobytes() + vec.tobytes())


def _fv(rng, dim):
    return rng.standard_normal(dim).astype(np.float32)


def _ark_case(name):
    """(records' bytes) of each well-formed case."""
    rng = np.random.default_rng(3)
    if name == "fixed_width":
        recs = [(f"mtg{r:03d}_{i:06d}", _fv(rng, 16)) for r in range(3)
                for i in range(300)]
    elif name == "width_change":
        recs = [(f"rec_{i}", _fv(rng, 8)) for i in range(9900, 10100)]
    elif name == "mixed_dims":
        recs = ([(f"recA_{i:03d}", _fv(rng, 8)) for i in range(90)]
                + [(f"recB_{i:03d}", _fv(rng, 12)) for i in range(70)]
                + [(f"recC_{i:03d}", _fv(rng, 8 + i % 2)) for i in range(5)])
    elif name == "dv":
        return b"".join(
            [_vec_record(f"recA_{i:03d}", rng.standard_normal(6), b"DV ")
             for i in range(80)]
            + [_vec_record(f"recB_{i:03d}", _fv(rng, 6)) if i % 3 else
               _vec_record(f"recB_{i:03d}", rng.standard_normal(6), b"DV ")
               for i in range(30)]
            + [_vec_record(f"recB_{i:03d}", _fv(rng, 6)) for i in range(30, 40)])
    elif name == "returns":
        recs = ([(f"recA_{i:04d}", _fv(rng, 4)) for i in range(100)]
                + [(f"recB_{i:04d}", _fv(rng, 4)) for i in range(100)]
                + [(f"recA_{i:04d}", _fv(rng, 4)) for i in range(100, 200)])
    elif name == "non_ascii":
        recs = ([(f"réunion_{i:03d}", _fv(rng, 4)) for i in range(100)]
                + [(f"rec_ü{i:02d}", _fv(rng, 4)) for i in range(70)]
                + [(f"rec_{i:03d}", _fv(rng, 4)) for i in range(70)])
    elif name == "payload_bytes":
        # payloads that hold ' ' and '_' (and a key's bytes) everywhere
        vec = np.frombuffer(b" _ _rec_" * 8, np.float32)
        recs = [(f"rec_{i:04d}", vec.copy()) for i in range(150)]
    elif name == "no_underscore":
        recs = ([(f"u{i:03d}", _fv(rng, 4)) for i in range(40)]
                + [("same", _fv(rng, 4)) for _ in range(40)])
    elif name == "one_record":
        recs = [("rec_0", _fv(rng, 5))]
    else:
        assert name == "empty"
        recs = []
    return b"".join(_vec_record(k, v) for k, v in recs)


ARK_CASES = ["fixed_width", "width_change", "mixed_dims", "dv", "returns",
             "non_ascii", "payload_bytes", "no_underscore", "one_record",
             "empty"]


def _outcome(fn):
    """fn()'s value, or the type and text of what it raised."""
    try:
        return "value", fn()
    except Exception as e:   # noqa: BLE001 — the failure is the outcome
        return "raised", (type(e), str(e))


@pytest.mark.parametrize("case", ARK_CASES)
def test_vec_ark_readers_are_vbx_tpus(tmp_path, case):
    """read_vec_ark_grouped, iter_vec_ark and group_by_recording over it
    give what vbx_tpu's stream reader gives: the keys, the groups (a recording that comes back is a
    second group), the dtype and every byte of every vector."""
    from vbx_tpu.io import ark as j_ark
    from vbx_tpu_torch.io import ark as t_ark

    path = str(tmp_path / "x.ark")
    with open(path, "wb") as f:
        f.write(_ark_case(case))

    def grouped(groups):
        return [(rec, keys, x.dtype, x.shape, x.tobytes())
                for rec, keys, x in groups]

    got = _outcome(lambda: grouped(t_ark.read_vec_ark_grouped(path)))
    ref = _outcome(lambda: grouped(j_ark.group_by_recording(
        j_ark.iter_vec_ark(path))))
    assert got == ref
    assert _outcome(lambda: grouped(t_ark.group_by_recording(
        t_ark.iter_vec_ark(path)))) == ref
    if case == "mixed_dims":   # recC's dims differ: np.stack's error
        assert got[0] == "raised"
    elif case == "returns":
        assert [g[0] for g in got[1]] == ["recA", "recB", "recA"]
    got = [(k, v.dtype, v.shape, v.tobytes())
           for k, v in t_ark.iter_vec_ark(path)]
    ref = [(k, v.dtype, v.shape, v.tobytes())
           for k, v in j_ark.iter_vec_ark(path)]
    assert got == ref
    assert len(got) == {"empty": 0, "one_record": 1}.get(case, len(got))


def _good(i, dim=4):
    return _vec_record(f"rec_{i:04d}", np.arange(dim, dtype=np.float32))


ARK_ERRORS = {
    "eof_in_key": _good(0) + b"rec_0001",
    "empty_key": _good(0) + b" \x00BFV \x04" + np.int32(0).tobytes(),
    # after a run of good records of the same layout, so the bulk key
    # decode meets it
    "key_not_utf8": b"".join(_good(i) for i in range(100))
    + _good(100).replace(b"rec_0100", b"rec_\xff\xfe00"),
    "text_ark": b"utt_1  [ 1 2 3 ]\nutt_2  [ 4 5 6 ]\n",
    "bad_vector_type": _good(0) + _good(1).replace(b"FV ", b"XV "),
    "no_dim_marker": _good(0) + _good(1).replace(b"\x04", b"\x05", 1),
    "eof_in_dim": _good(0) + _good(1)[:17],
    "negative_dim": _good(0) + _vec_record("rec_0001", np.zeros(2, np.float32),
                                           dim=-2),
    "truncated_record": b"".join(_good(i) for i in range(100))
    + _good(100)[:-3],
}


@pytest.mark.parametrize("case", sorted(ARK_ERRORS))
def test_vec_ark_errors_are_vbx_tpus(tmp_path, case):
    """A malformed ark raises what vbx_tpu's stream reader raises, with the
    same text, from both readers."""
    from vbx_tpu.io import ark as j_ark
    from vbx_tpu_torch.io import ark as t_ark

    path = str(tmp_path / "x.ark")
    with open(path, "wb") as f:
        f.write(ARK_ERRORS[case])
    ref = _outcome(lambda: list(j_ark.iter_vec_ark(path)))
    assert ref[0] == "raised"
    for reader in (t_ark.iter_vec_ark, t_ark.read_vec_ark_grouped):
        got = _outcome(lambda: list(reader(path)))
        if case == "negative_dim":
            # vbx_tpu's text is the file object's, for a negative read
            assert got == ("raised", (ValueError, "bad ark vector dim -2"))
        else:
            assert got == ref
    # what was read before the fault comes out first, as from a stream
    seen = []
    with pytest.raises(ref[1][0]):
        for key, _ in t_ark.iter_vec_ark(path):
            seen.append(key)
    assert seen == [k for k, _ in _stream_until_fault(j_ark, path)]


def _stream_until_fault(j_ark, path):
    out = []
    try:
        for item in j_ark.iter_vec_ark(path):
            out.append(item)
    except Exception:   # noqa: BLE001 — the records before the fault
        pass
    return out


def test_read_counters_see_bulk_and_walked_records(tmp_path):
    """A fixed-width corpus is located in bulk, a run a recording, its
    first record walked; keys of ragged widths make short runs, each of
    whose first record is walked. The counters add up."""
    from vbx_tpu_torch.io import ark as t_ark

    fixed, ragged = str(tmp_path / "f.ark"), str(tmp_path / "r.ark")
    with open(fixed, "wb") as f:
        f.write(_ark_case("fixed_width"))
    before = t_ark.read_counters()
    assert len(list(t_ark.read_vec_ark_grouped(fixed))) == 3
    c = t_ark.read_counters(since=before)
    assert c == {"records": 900, "bytes": os.path.getsize(fixed),
                 "bulk": 897, "walked": 3, "runs": 3}
    rng = np.random.default_rng(1)
    widths = [1, 2, 3, 3, 3, 1, 2, 2, 4, 1]
    with open(ragged, "wb") as f:
        for i, w in enumerate(widths):
            f.write(_vec_record(f"rec_{i:0{w}d}", _fv(rng, 4)))
    before = t_ark.read_counters()
    assert len(list(t_ark.iter_vec_ark(ragged))) == 10
    c = t_ark.read_counters(since=before)
    # runs: 1 | 2 | 3 3 3 | 1 | 2 2 | 4 | 1
    assert c == {"records": 10, "bytes": os.path.getsize(ragged),
                 "bulk": 3, "walked": 7, "runs": 7}


def test_read_counters_lose_no_update_across_threads(tmp_path):
    """Readers on more threads than cores, switching as often as the
    interpreter allows: the counters add every record of every read."""
    import threading

    from vbx_tpu_torch.io import ark as t_ark

    path = str(tmp_path / "x.ark")
    with open(path, "wb") as f:
        f.write(_ark_case("width_change"))   # two runs a read
    n_threads, n_reads = 2 * (os.cpu_count() or 1) + 1, 20

    def work():
        for _ in range(n_reads):
            assert len(list(t_ark.read_vec_ark_grouped(path))) == 1

    before = t_ark.read_counters()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    c = t_ark.read_counters(since=before)
    reads = n_threads * n_reads
    assert c == {"records": 200 * reads,
                 "bytes": os.path.getsize(path) * reads,
                 "bulk": 198 * reads, "walked": 2 * reads,
                 "runs": 2 * reads}


def _seg_case(name):
    rows = [(f"recA_{i:03d}", "recA", round(i * 0.24, 2),
             round(i * 0.24 + 1.44, 2)) for i in range(5)]
    text = "".join(f"{n} {r} {s} {e}\n" for n, r, s, e in rows)
    if name == "blank_lines":
        return "\n" + text.replace("\n", "\n\n   \n", 2) + "\t\n"
    if name == "fifth_column":
        return text.replace("\n", " extra\n", 2)
    if name == "split_recording":
        other = "recB_000 recB 0.5 1.9\nrecB_001 recB 0.74 2.14\n"
        lines = text.splitlines(keepends=True)
        return "".join(lines[:2]) + other + "".join(lines[2:]) + \
            "recB_002 recB 1.0 2.4\n"
    if name == "whitespace":
        return text.replace(" ", " \t ").replace("\n", "\r\n") + \
            "recC_0\x0b recC\x0c1e-3 \x1c2.5E+1"
    if name == "non_ascii":
        return text + "réc_000 réc 0.0 1.5\n"
    if name == "short_line":
        return text + "recA_009 recA 2.0\n"
    if name == "bad_time":
        return text.replace("0.48", "0,48")
    assert name == "empty"
    return "\n\n"


SEG_CASES = ["blank_lines", "fifth_column", "split_recording", "whitespace",
             "non_ascii", "short_line", "bad_time", "empty", "grid"]


def _timing(d):
    return [(rec, names.dtype, names.tolist(), times.dtype, times.shape,
             times.flags.c_contiguous, times.tobytes())
            for rec, (names, times) in d.items()]


@pytest.mark.parametrize("case", SEG_CASES)
def test_timing_dict_is_vbx_tpus(tmp_path, case):
    """read_xvector_timing_dict gives vbx_tpu's line-by-line result bit for
    bit (or raises as it does); 'grid' is the benchmark's 0.24 s grid as
    write_segments writes it, the times float repr's long forms."""
    from vbx_tpu.io import segments as j_seg
    from vbx_tpu_torch.io import segments as t_seg

    path = str(tmp_path / "x.seg")
    if case == "grid":
        t_seg.write_segments(path, [
            (f"mtg{r:03d}_{i:06d}", f"mtg{r:03d}", i * 0.24, i * 0.24 + 1.44)
            for r in range(3) for i in range(2000)])
    else:
        with open(path, "w", newline="") as f:
            f.write(_seg_case(case))
    got = _outcome(lambda: _timing(t_seg.read_xvector_timing_dict(path)))
    ref = _outcome(lambda: _timing(j_seg.read_xvector_timing_dict(path)))
    assert got == ref
    assert ref[0] == ("raised" if case in ("short_line", "bad_time")
                      else "value")
    if case == "split_recording":
        assert [r[0] for r in got[1]] == ["recA", "recB"]
