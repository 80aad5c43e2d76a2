"""Kaldi binary MATRIX codecs: dense (FM/DM), compressed (CM/CM2/CM3),
and sparse (SM) — plus the matrix-archive form.

Parity surface: the reference reads matrices through kaldi_io
(`VBx/kaldi_utils.py:80-106` dispatches FM/DM itself and delegates
CM*/SM to kaldi_io's readers; `:109-147` carries a first-party sparse
reader). The diarization recipes only ever read float-vector arks, but a
Kaldi-ecosystem user's feature/posterior archives are routinely
compressed matrices — this module closes that robustness gap with
first-party readers AND writers (the writers double as the round-trip
test oracle; no kaldi_io package is needed). A copy of vbx_tpu's codec.

Format notes (Kaldi src/matrix/compressed-matrix.cc semantics):

- 'CM ' (kOneByteWithColHeaders): GlobalHeader {f32 min, f32 range,
  i32 rows, i32 cols}, then per-column 4x uint16 quantized percentiles
  (p0, p25, p75, p100; uint16 h -> min + range * h / 65535), then uint8
  data stored COLUMN-major. A byte c decodes piecewise-linearly within
  its column: [0, 64] -> [p0, p25], (64, 192] -> [p25, p75],
  (192, 255] -> [p75, p100].
- 'CM2' (kTwoByte): same GlobalHeader, uint16 data ROW-major,
  value = min + range * d / 65535.
- 'CM3' (kOneByte): uint8 data ROW-major, value = min + range * d / 255.
- 'SM ' (sparse float matrix): i08+i32 num_rows, then per row a sparse
  vector 'SV ' {i08+i32 dim, i08+i32 num_elems, then (i08-sized int32
  index, i08-sized float32 value) pairs} (reference reader:
  kaldi_utils.py:109-147).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from vbx_tpu_torch.io.ark import _read_key
from vbx_tpu_torch.io.common import open_sink


def _expect(fd: BinaryIO, token: bytes, what: str) -> None:
    got = fd.read(len(token))
    if got != token:
        raise ValueError(f"bad kaldi {what}: expected {token!r}, "
                         f"got {got!r}")


def _read_i32(fd: BinaryIO, what: str) -> int:
    _expect(fd, b"\x04", f"{what} int size")
    return struct.unpack("<i", fd.read(4))[0]


def read_mat_binary(fd: BinaryIO) -> np.ndarray:
    """One binary matrix (after any '\\0B' marker): FM/DM dense, CM/CM2/CM3
    compressed (decompressed to float32), or SM sparse (returned dense
    float32 — use read_sparse_mat for the scipy CSR form)."""
    header = fd.read(3).decode("latin1")
    if header.startswith("CM"):
        return _read_compressed(fd, header)
    if header.startswith("SM"):
        return read_sparse_mat(fd, _header_consumed=True).toarray()
    if header == "FM ":
        dt, size = np.dtype("<f4"), 4
    elif header == "DM ":
        dt, size = np.dtype("<f8"), 8
    else:
        raise ValueError(f"unknown kaldi matrix header {header!r}")
    rows = _read_i32(fd, "rows")
    cols = _read_i32(fd, "cols")
    buf = fd.read(rows * cols * size)
    return np.frombuffer(buf, dtype=dt).reshape(rows, cols)


def _read_compressed(fd: BinaryIO, header: str) -> np.ndarray:
    gmin, grange, rows, cols = struct.unpack("<ffii", fd.read(16))
    if header == "CM ":
        ch = np.frombuffer(fd.read(cols * 8), dtype="<u2")
        ch = gmin + grange * ch.astype(np.float64).reshape(cols, 4) / 65535.0
        data = np.frombuffer(fd.read(cols * rows),
                             dtype=np.uint8).reshape(cols, rows)
        p0, p25, p75, p100 = (ch[:, i:i + 1] for i in range(4))
        c = data.astype(np.float64)
        lo = p0 + (p25 - p0) * (c / 64.0)
        mid = p25 + (p75 - p25) * ((c - 64.0) / 128.0)
        hi = p75 + (p100 - p75) * ((c - 192.0) / 63.0)
        out = np.where(c <= 64, lo, np.where(c <= 192, mid, hi))
        return np.ascontiguousarray(out.T, dtype=np.float32)
    if header == "CM2":
        d = np.frombuffer(fd.read(rows * cols * 2), dtype="<u2")
        return (gmin + grange * d.astype(np.float64) / 65535.0) \
            .reshape(rows, cols).astype(np.float32)
    if header == "CM3":
        d = np.frombuffer(fd.read(rows * cols), dtype=np.uint8)
        return (gmin + grange * d.astype(np.float64) / 255.0) \
            .reshape(rows, cols).astype(np.float32)
    raise ValueError(f"unknown compressed-matrix header {header!r}")


def read_sparse_mat(fd: BinaryIO, _header_consumed: bool = False):
    """Sparse float matrix ('SM ') -> scipy.sparse.csr_matrix
    (reference: kaldi_utils._read_sparse_mat:109-147)."""
    from scipy.sparse import csr_matrix

    if not _header_consumed:
        _expect(fd, b"SM ", "sparse-matrix header")
    num_rows = _read_i32(fd, "sparse rows")
    rows, cols, vals = [], [], []
    max_dim = 0
    for i in range(num_rows):
        _expect(fd, b"SV ", "sparse-vector header")
        dim = _read_i32(fd, "sparse dim")
        n = _read_i32(fd, "sparse nnz")
        max_dim = max(max_dim, dim)
        for _ in range(n):
            # the per-element size byte admits exactly 4 or 8; anything
            # else is a corrupt/truncated archive and a silent best-guess
            # read would desynchronize the rest of the stream, so fail
            # loudly like _expect
            size = fd.read(1)[0]
            if size not in (4, 8):
                raise ValueError(
                    f"sparse-vector index size byte {size} not in (4, 8)")
            idx = int(np.frombuffer(fd.read(size),
                                    dtype="<i4" if size == 4 else "<i8")[0])
            size = fd.read(1)[0]
            if size not in (4, 8):
                raise ValueError(
                    f"sparse-vector value size byte {size} not in (4, 8)")
            val = float(np.frombuffer(fd.read(size),
                                      dtype="<f4" if size == 4 else "<f8")[0])
            rows.append(i)
            cols.append(idx)
            vals.append(val)
    return csr_matrix((vals, (rows, cols)), shape=(num_rows, max_dim))


# -- writers (fixture/oracle + interchange) ---------------------------------

def write_mat_binary(fd: BinaryIO, mat: np.ndarray,
                     compression: Optional[int] = None) -> None:
    """Write one matrix: dense float32 ('FM ') / float64 ('DM ') by dtype,
    or compressed with `compression` in {1: 'CM ', 2: 'CM2', 3: 'CM3'}."""
    mat = np.asarray(mat)
    if compression is not None:
        _write_compressed(fd, mat.astype(np.float64), compression)
        return
    if mat.dtype == np.float64:
        fd.write(b"DM ")
    else:
        mat = mat.astype(np.float32)
        fd.write(b"FM ")
    fd.write(b"\x04" + struct.pack("<i", mat.shape[0]))
    fd.write(b"\x04" + struct.pack("<i", mat.shape[1]))
    fd.write(np.ascontiguousarray(mat).tobytes())


def _q16(x, gmin, grange):
    f = np.clip((np.asarray(x) - gmin) / max(grange, 1e-30), 0.0, 1.0)
    return np.round(f * 65535.0).astype("<u2")


def _write_compressed(fd: BinaryIO, mat: np.ndarray, compression: int) -> None:
    rows, cols = mat.shape
    gmin = float(mat.min()) if mat.size else 0.0
    grange = float(mat.max() - gmin) if mat.size else 1.0
    if grange <= 0:
        grange = 1.0
    if compression == 2:
        fd.write(b"CM2")
        fd.write(struct.pack("<ffii", gmin, grange, rows, cols))
        d = np.round(np.clip((mat - gmin) / grange, 0, 1) * 65535.0)
        fd.write(d.astype("<u2").tobytes())
        return
    if compression == 3:
        fd.write(b"CM3")
        fd.write(struct.pack("<ffii", gmin, grange, rows, cols))
        d = np.round(np.clip((mat - gmin) / grange, 0, 1) * 255.0)
        fd.write(d.astype(np.uint8).tobytes())
        return
    if compression != 1:
        raise ValueError(f"compression must be 1, 2 or 3, got {compression}")
    fd.write(b"CM ")
    fd.write(struct.pack("<ffii", gmin, grange, rows, cols))
    # per-column quantized percentiles, stored as uint16 of the global
    # range, then each entry quantized piecewise within its column
    colq = np.empty((cols, 4), dtype="<u2")
    perc = np.empty((cols, 4))
    for j in range(cols):
        c = np.sort(mat[:, j])
        pts = [c[0], c[len(c) // 4], c[(3 * len(c)) // 4], c[-1]]
        q = _q16(pts, gmin, grange)
        # keep the decoded percentiles strictly ordered enough to invert
        q = np.maximum.accumulate(q)
        colq[j] = q
        perc[j] = gmin + grange * q.astype(np.float64) / 65535.0
    fd.write(colq.tobytes())
    p0, p25, p75, p100 = perc.T
    out = np.empty((cols, rows), dtype=np.uint8)
    for j in range(cols):
        v = mat[:, j]
        lo = np.clip((v - p0[j]) / max(p25[j] - p0[j], 1e-30), 0, 1) * 64.0
        mid = 64.0 + np.clip((v - p25[j]) / max(p75[j] - p25[j], 1e-30),
                             0, 1) * 128.0
        hi = 192.0 + np.clip((v - p75[j]) / max(p100[j] - p75[j], 1e-30),
                             0, 1) * 63.0
        out[j] = np.round(np.where(v <= p25[j], lo,
                                   np.where(v <= p75[j], mid,
                                            hi))).astype(np.uint8)
    fd.write(out.tobytes())


# -- matrix archives ---------------------------------------------------------

def iter_mat_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Iterate (key, matrix) over a Kaldi binary matrix archive; every
    matrix encoding above (dense/compressed/sparse) is accepted, sparse
    densified (vector arks: io.ark.iter_vec_ark)."""
    with open(path, "rb") as fd:
        while True:
            key = _read_key(fd)
            if key is None:
                return
            _expect(fd, b"\x00B", "binary marker")
            yield key, read_mat_binary(fd)


def read_mat_ark(path: str) -> Dict[str, np.ndarray]:
    return dict(iter_mat_ark(path))


def write_mat_ark(path_or_fd, data: Iterable[Tuple[str, np.ndarray]],
                  compression: Optional[int] = None) -> None:
    with open_sink(path_or_fd, "wb") as fd:
        for key, mat in data:
            fd.write(key.encode() + b" \x00B")
            write_mat_binary(fd, mat, compression=compression)
