"""Kaldi float-vector ark codec (first-party, no kaldi_io dependency).

Binary record layout (verified against the reference's shipped
exp/ES2005a.ark; consumed by the reference via kaldi_io.read_vec_flt_ark at
VBx/vbhmm.py:117 and produced at VBx/predict.py:193):

    <key> <space> \\0B FV<space> \\4 <int32 dim, little-endian> <float32 x dim>

Keys are utf-8, terminated by the single space. 'DV ' (float64) records are
also accepted on read.

Readers take the file whole (one read) and locate its records a run at a
time: the first record of a run is read as a stream reads it, and the
records after it that repeat its layout (key length, header, dim,
recording) are checked together in one numpy comparison. A run ends where
the layout changes; `read_counters` says how many records were located so.
"""

from __future__ import annotations

import io
import itertools
import struct
import threading
from typing import (BinaryIO, Dict, Iterable, Iterator, List, NamedTuple,
                    Optional, Tuple)

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


_VEC_TYPES = {b"FV ": np.dtype(np.float32), b"DV ": np.dtype(np.float64)}


def _read_vec_head(fd: BinaryIO) -> Tuple[np.dtype, int]:
    """A vector record's header after its key: (dtype, dim)."""
    binmark = fd.read(2)
    if binmark != b"\x00B":
        raise ValueError(f"only binary arks supported (got {binmark!r})")
    typ = fd.read(3)
    if typ not in _VEC_TYPES:
        raise ValueError(f"unsupported vector type {typ!r}")
    if fd.read(1) != b"\x04":
        raise ValueError("expected int32 dim marker")
    (dim,) = struct.unpack("<i", fd.read(4))
    return _VEC_TYPES[typ], dim


# bytes between a key's end and its vector's payload: ' ', '\0B', type,
# '\4', int32 dim
_HEAD = 11
_SPACE, _UNDERSCORE = 0x20, 0x5F
# records checked at once: the first window, doubled while they all match,
# so a run of m records costs O(m) however short it is
_WINDOW = 64

_READ_LOCK = threading.Lock()
# cumulative over every vector ark read: records, their bytes, those that
# repeated the layout of the record before them (located in bulk), those
# that did not (walked: the first of each run), and the runs
_READ_COUNTERS = dict.fromkeys(("records", "bytes", "bulk", "walked", "runs"),
                               0)


def read_counters(since: Optional[dict] = None) -> dict:
    """A snapshot of the vector ark readers' cumulative counters; given an
    earlier snapshot, the counts since it."""
    with _READ_LOCK:
        now = dict(_READ_COUNTERS)
    if since is None:
        return now
    return {k: v - since[k] for k, v in now.items()}


class _Run(NamedTuple):
    """Records that repeat one layout back to back: the first payload's
    offset, the record stride, the keys, dtype and dim."""
    offset: int
    stride: int
    keys: List[str]
    dtype: np.dtype
    dim: int

    def view(self, buf) -> np.ndarray:
        """The run's vectors as an [m, dim] view of the buffer."""
        return np.ndarray((len(self.keys), self.dim), self.dtype, buf,
                          self.offset, (self.stride, self.dtype.itemsize))


def _read_whole(path: str) -> bytes:
    with open(path, "rb") as fd:
        return fd.read()


def _repeats(buf, p: int, L: int, P: int, stride: int, m_max: int) -> int:
    """How many records from the one at p, up to m_max, share its layout:
    the same key length L (bytes L of each key not a space, byte L a
    space), header and dim, and the same key bytes up to P with no '_'
    after them (the same recording_of_key)."""
    n_head = L + _HEAD
    first = np.frombuffer(buf, np.uint8, n_head, p)
    k, w = 1, _WINDOW
    while k < m_max:
        m = min(w, m_max - k)
        head = np.ndarray((m, n_head), np.uint8, buf, p + k * stride,
                          (stride, 1))
        eq = head == first
        ok = eq[:, :P].all(1) & eq[:, L:].all(1)
        tail = head[:, P:L]
        ok &= ((tail != _SPACE) & (tail != _UNDERSCORE)).all(1)
        bad = np.flatnonzero(~ok)
        if bad.size:
            return k + int(bad[0])
        k += m
        w *= 2
    return k


def _keys(buf, p: int, L: int, stride: int, m: int) -> List[str]:
    """The keys of m records of key length L from p; where one is not
    utf-8, the keys before it (the walk raises for it)."""
    raw = np.ndarray((m, L), np.uint8, buf, p, (stride, 1)).tobytes()
    if raw.isascii():
        text = raw.decode("ascii")
        return [text[i:i + L] for i in range(0, m * L, L)]
    keys = []
    for i in range(0, m * L, L):
        try:
            keys.append(raw[i:i + L].decode())
        except UnicodeDecodeError:
            break
    return keys


def _runs(buf: bytes) -> Iterator[_Run]:
    """Locate the records of a vector ark held whole in `buf`, a run at a
    time.

    The record at the start of a run is walked as a stream reads it (its
    errors are the format's); the records after it that repeat its
    layout join the run, checked together. The first that does not
    starts the next run. A run never crosses a recording_of_key
    boundary."""
    fd, n, p = io.BytesIO(buf), len(buf), 0
    while True:
        fd.seek(p)
        key = _read_key(fd)
        if key is None:
            return
        L = fd.tell() - p - 1
        dtype, dim = _read_vec_head(fd)
        if dim < 0:
            raise ValueError(f"bad ark vector dim {dim}")
        stride = L + _HEAD + dim * dtype.itemsize
        if p + stride > n:
            raise ValueError("truncated ark record")
        cut = key.encode().rfind(b"_")
        m = _repeats(buf, p, L, cut + 1 if cut >= 0 else L, stride,
                     (n - p) // stride)
        keys = _keys(buf, p, L, stride, m)
        m = len(keys)
        with _READ_LOCK:
            c = _READ_COUNTERS
            c["records"] += m
            c["bytes"] += m * stride
            c["bulk"] += m - 1
            c["walked"] += 1
            c["runs"] += 1
        yield _Run(p + L + _HEAD, stride, keys, dtype, dim)
        p += m * stride


def iter_vec_ark(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream (key, vector) pairs from a Kaldi float-vector ark file."""
    buf = _read_whole(path)
    for run in _runs(buf):
        yield from zip(run.keys, run.view(buf).copy())


def read_vec_ark_grouped(path: str
                         ) -> Iterator[Tuple[str, List[str], np.ndarray]]:
    """Group consecutive ark records by recording name.

    Yields (recording, seg_names, x) with x an (N, D) array copied out of
    the file once, a strided copy a run, matching the reference's
    itertools.groupby streaming semantics (vbhmm.py:117-123): all
    x-vectors of one recording must be contiguous in the ark, and one that
    comes back later is a second group.
    """
    buf = _read_whole(path)
    for rec, group in itertools.groupby(
            _runs(buf), key=lambda run: recording_of_key(run.keys[0])):
        group = list(group)
        keys = [k for run in group for k in run.keys]
        if len({run.dim for run in group}) > 1:
            # raises as np.stack does on vectors of unequal length
            np.stack([v for run in group for v in run.view(buf)])
        x = np.empty((len(keys), group[0].dim),
                     np.result_type(*(run.dtype for run in group)))
        i = 0
        for run in group:
            x[i:i + len(run.keys)] = run.view(buf)
            i += len(run.keys)
        yield rec, keys, x


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
    """Group consecutive (key, vector) items by recording name, as
    read_vec_ark_grouped groups a file's records: for streams that are not
    an ark file read whole.

    Yields (recording, seg_names, x) with x an (N, D) float array, matching
    the reference's itertools.groupby streaming semantics (vbhmm.py:117-123):
    all x-vectors of one recording must be contiguous in the ark.
    """
    for rec, group in itertools.groupby(items, key=lambda e: recording_of_key(e[0])):
        names, vecs = zip(*group)
        yield rec, list(names), np.stack(vecs)
