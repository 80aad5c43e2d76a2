"""Kaldi float-vector ark codec (first-party, no kaldi_io dependency).

Binary record layout (verified against the reference's shipped
exp/ES2005a.ark; consumed by the reference via kaldi_io.read_vec_flt_ark at
VBx/vbhmm.py:117 and produced at VBx/predict.py:193):

    <key> <space> \\0B FV<space> \\4 <int32 dim, little-endian> <float32 x dim>

Keys are utf-8, terminated by the single space. 'DV ' (float64) records are
also accepted on read.
"""

from __future__ import annotations

import itertools
import struct
from typing import BinaryIO, Dict, Iterable, Iterator, List, Tuple

import numpy as np

from vbx_tpu_torch.io.common import open_sink


def _read_key(fd: BinaryIO) -> str | None:
    chars = []
    while True:
        c = fd.read(1)
        if not c:  # EOF
            if chars:
                frag = b"".join(chars)[:40]
                raise ValueError(
                    f"truncated ark: EOF inside record key {frag!r}")
            return None
        if c == b" ":
            if not chars:
                raise ValueError("empty ark key")
            try:
                return b"".join(chars).decode()
            except UnicodeDecodeError as e:
                raise ValueError(f"malformed ark key (not utf-8): {e}")
        chars.append(c)


def _read_vec(fd: BinaryIO) -> np.ndarray:
    binmark = fd.read(2)
    if binmark != b"\x00B":
        raise ValueError(f"only binary arks supported (got {binmark!r})")
    typ = fd.read(3)
    if typ == b"FV ":
        dtype, isize = np.float32, 4
    elif typ == b"DV ":
        dtype, isize = np.float64, 8
    else:
        raise ValueError(f"unsupported vector type {typ!r}")
    if fd.read(1) != b"\x04":
        raise ValueError("expected int32 dim marker")
    (dim,) = struct.unpack("<i", fd.read(4))
    buf = fd.read(dim * isize)
    if len(buf) != dim * isize:
        raise ValueError("truncated ark record")
    return np.frombuffer(buf, dtype=dtype)


def iter_vec_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream (key, vector) pairs from a Kaldi float-vector ark file."""
    with open(path, "rb") as fd:
        while True:
            key = _read_key(fd)
            if key is None:
                return
            yield key, _read_vec(fd)


def read_vec_ark(path: str) -> Dict[str, np.ndarray]:
    return dict(iter_vec_ark(path))


def write_vec_ark(path_or_fd, data: Iterable[Tuple[str, np.ndarray]]) -> None:
    """Write (key, float32 vector) records in Kaldi binary ark format."""

    def _write(fd: BinaryIO):
        for key, vec in data:
            vec = np.ascontiguousarray(vec, dtype=np.float32)
            if vec.ndim != 1:
                raise ValueError(f"expected 1-D vector for key {key!r}")
            if not key or any(c.isspace() for c in key):
                # the format delimits the key with a space: whitespace in
                # a key (or an empty key) would SILENTLY corrupt the
                # stream for every later record
                raise ValueError(
                    f"ark key must be non-empty with no whitespace, "
                    f"got {key!r}")
            fd.write(key.encode() + b" ")
            fd.write(b"\x00BFV \x04")
            fd.write(struct.pack("<i", vec.shape[0]))
            fd.write(vec.tobytes())

    with open_sink(path_or_fd, "wb") as fd:
        _write(fd)


def write_txt_vectors(path: str, data: Dict[str, np.ndarray]) -> None:
    """Write vectors in Kaldi text format, sorted by key (reference surface
    predict.py:56-65): `<key>  [ v0 v1 ... ]` per line."""
    with open(path, "w") as f:
        for name in sorted(data):
            vals = " ".join(str(x) for x in np.asarray(data[name]).ravel())
            f.write(f"{name}  [ {vals} ]\n")


def read_txt_vectors(path: str) -> Dict[str, np.ndarray]:
    """Read the text-format vectors written by write_txt_vectors."""
    out: Dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, rest = line.split(None, 1)
            body = rest[rest.index("[") + 1:rest.rindex("]")]
            out[key] = np.asarray([float(x) for x in body.split()],
                                  dtype=np.float64)
    return out


def recording_of_key(key: str) -> str:
    """Recording name for an x-vector key (reference: vbhmm.py:119 groups by
    key.rsplit('_', 1)[0])."""
    return key.rsplit("_", 1)[0]


def group_by_recording(
    items: Iterable[Tuple[str, np.ndarray]]
) -> Iterator[Tuple[str, List[str], np.ndarray]]:
    """Group consecutive ark records by recording name.

    Yields (recording, seg_names, x) with x an (N, D) float array, matching
    the reference's itertools.groupby streaming semantics (vbhmm.py:117-123):
    all x-vectors of one recording must be contiguous in the ark.
    """
    for rec, group in itertools.groupby(items, key=lambda e: recording_of_key(e[0])):
        names, vecs = zip(*group)
        yield rec, list(names), np.stack(vecs)
