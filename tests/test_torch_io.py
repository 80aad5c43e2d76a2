"""The port's HDF5 codec (vbx_tpu_torch.io.hdf5), which reads transform.h5
on every machine and writes it, against h5py and vbx_tpu's reader."""

import os
import sys

import h5py
import numpy as np
import pytest

from vbx_tpu.io.transform import read_xvec_transform as jax_read
from vbx_tpu_torch.io import hdf5
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
