"""Frozen copies of the file writers the benchmark makes its inputs with,
so that the inputs do not change when the program's own codecs do.

Copied from vbx_tpu_torch/io/ark.py:write_vec_ark,
vbx_tpu_torch/io/segments.py:write_segments,
vbx_tpu_torch/testing.py:write_plda and vbx_tpu_torch/io/hdf5.py:
write_datasets (its helpers and constants) as they stood when the
benchmark was defined; `read_rttm_labels` is the benchmark's own.
"""

import struct
from typing import Dict, Iterable, Tuple

import numpy as np

_SIG = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_DATASPACE, _DATATYPE, _FILL, _LAYOUT, _CONT, _STAB = 1, 3, 5, 8, 16, 17


def write_vec_ark(path: str, data: Iterable[Tuple[str, np.ndarray]]) -> None:
    """(key, float32 vector) records in Kaldi binary ark format."""
    with open(path, "wb") as fd:
        for key, vec in data:
            vec = np.ascontiguousarray(vec, dtype=np.float32)
            fd.write(key.encode() + b" ")
            fd.write(b"\x00BFV \x04")
            fd.write(struct.pack("<i", vec.shape[0]))
            fd.write(vec.tobytes())


def write_segments(path: str, rows) -> None:
    """(name, recording, start, end) rows."""
    with open(path, "w") as fp:
        for name, rec, start, end in rows:
            fp.write(f"{name} {rec} {start} {end}\n")


def write_plda(path: str, mu: np.ndarray, tr: np.ndarray,
               psi: np.ndarray) -> None:
    """Kaldi binary <Plda> object (float64 vectors and matrix)."""
    def vec(v):
        v = np.ascontiguousarray(v, np.float64)
        return b"DV \x04" + struct.pack("<i", v.size) + v.tobytes()

    tr = np.ascontiguousarray(tr, np.float64)
    mat = (b"DM \x04" + struct.pack("<i", tr.shape[0]) + b"\x04"
           + struct.pack("<i", tr.shape[1]) + tr.tobytes())
    with open(path, "wb") as f:
        f.write(b"\x00B<Plda> " + vec(mu) + mat + vec(psi) + b"</Plda> ")


def write_transform(path: str, mean1: np.ndarray, lda: np.ndarray,
                    mean2: np.ndarray) -> None:
    """transform.h5: datasets mean1, lda, mean2 in the root group."""
    write_datasets(path, {"mean1": mean1, "lda": lda, "mean2": mean2})


def read_rttm_labels(path: str, centers: np.ndarray) -> np.ndarray:
    """The speaker an RTTM gives at each time in `centers` (seconds), as
    an index into the file's speaker names in order of first appearance;
    -1 where no turn covers the time."""
    names: Dict[str, int] = {}
    turns = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p or p[0] != "SPEAKER":
                continue
            t0, dur = float(p[3]), float(p[4])
            turns.append((t0, t0 + dur, names.setdefault(p[7], len(names))))
    out = np.full(len(centers), -1, np.int64)
    for t0, t1, k in turns:
        out[(centers >= t0) & (centers < t1)] = k
    return out


def _msg(mtype: int, data: bytes) -> bytes:
    data += b"\0" * (-len(data) % 8)
    return struct.pack("<HHB3x", mtype, len(data), 0) + data


def _object_header(messages: bytes, n: int) -> bytes:
    return struct.pack("<BBHII4x", 1, 0, n, 1, len(messages)) + messages


def _datatype(dt: np.dtype) -> bytes:
    size = dt.itemsize
    if dt.kind == "f":
        if size == 8:
            props = struct.pack("<HHBBBBI", 0, 64, 52, 11, 0, 52, 1023)
            sign = 63
        elif size == 4:
            props = struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127)
            sign = 31
        else:
            raise ValueError(f"unsupported float size {size}")
        bits = bytes([0x20, sign, 0])       # little-endian, implied msb
        return bytes([0x11]) + bits + struct.pack("<I", size) + props
    if dt.kind in "iu":
        bits = bytes([0x08 if dt.kind == "i" else 0, 0, 0])
        return (bytes([0x10]) + bits + struct.pack("<I", size)
                + struct.pack("<HH", 0, 8 * size))
    raise ValueError(f"unsupported dtype {dt}")


def write_datasets(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write little-endian numeric arrays as contiguous datasets of the
    root group (superblock version 0, one symbol-table group)."""
    K_LEAF, K_NODE = 4, 16
    names = sorted(arrays)
    if not 0 < len(names) <= 2 * K_LEAF:
        raise ValueError(f"1..{2 * K_LEAF} datasets per file, got "
                         f"{len(names)}")
    arrs = [np.ascontiguousarray(arrays[k]) for k in names]
    arrs = [a.astype(a.dtype.newbyteorder("<")) for a in arrs]

    # local heap data: "" at 0, then each name, 8-byte padded
    heap_data = bytearray(b"\0" * 8)
    name_off = []
    for k in names:
        name_off.append(len(heap_data))
        s = k.encode() + b"\0"
        heap_data += s + b"\0" * (-len(s) % 8)

    # layout: superblock | root header | btree | heap header | heap data |
    #         snod | dataset headers | raw data
    sb_size, root_size = 96, 16 + 8 + 16
    btree_size = 24 + (2 * K_NODE + 1) * 8 + 2 * K_NODE * 8
    a_root = sb_size
    a_btree = a_root + root_size
    a_heap = a_btree + btree_size
    a_heapdata = a_heap + 32
    a_snod = a_heapdata + len(heap_data)
    snod_size = 8 + 2 * K_LEAF * 40
    p = a_snod + snod_size

    headers, a_headers = [], []
    for a in arrs:
        space = struct.pack("<BBBx4x", 1, a.ndim, 0) + b"".join(
            struct.pack("<Q", d) for d in a.shape)
        fill = struct.pack("<BBBB", 2, 2, 0, 0)
        # layout address filled in below, once the data offsets are known
        msgs = [(_DATASPACE, space), (_DATATYPE, _datatype(a.dtype)),
                (_FILL, fill)]
        size = 16 + sum(len(_msg(t, d)) for t, d in msgs) + len(
            _msg(_LAYOUT, b"\0" * 18))
        headers.append(msgs)
        a_headers.append(p)
        p += size
    a_data = []
    for a in arrs:
        p += -p % 8
        a_data.append(p)
        p += a.nbytes
    eof = p

    out = bytearray(eof)
    # superblock v0 with the root group's symbol table entry (cache type 1)
    sb = (_SIG + bytes([0, 0, 0, 0, 0, 8, 8, 0])
          + struct.pack("<HHI", K_LEAF, K_NODE, 0)
          + struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
          + struct.pack("<QQI4xQQ", 0, a_root, 1, a_btree, a_heap))
    out[0:len(sb)] = sb
    root = _object_header(_msg(_STAB, struct.pack("<QQ", a_btree, a_heap)),
                          1)
    out[a_root:a_root + len(root)] = root
    btree = (b"TREE" + struct.pack("<BBH", 0, 0, 1)
             + struct.pack("<QQ", _UNDEF, _UNDEF)
             + struct.pack("<QQQ", 0, a_snod, name_off[-1]))
    out[a_btree:a_btree + len(btree)] = btree
    # free-list head 1: libhdf5's "no free block" (H5HL_FREE_NULL)
    heap = (b"HEAP" + bytes([0, 0, 0, 0])
            + struct.pack("<QQQ", len(heap_data), 1, a_heapdata))
    out[a_heap:a_heap + len(heap)] = heap
    out[a_heapdata:a_heapdata + len(heap_data)] = heap_data
    snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + b"".join(
        struct.pack("<QQI4x16x", off, hdr, 0) for off, hdr in
        zip(name_off, a_headers))
    out[a_snod:a_snod + len(snod)] = snod
    for msgs, a, ah, ad in zip(headers, arrs, a_headers, a_data):
        body = b"".join(_msg(t, d) for t, d in msgs) + _msg(
            _LAYOUT, struct.pack("<BBQQ", 3, 1, ad, a.nbytes))
        hdr = _object_header(body, len(msgs) + 1)
        out[ah:ah + len(hdr)] = hdr
        out[ad:ad + a.nbytes] = a.tobytes()
    with open(path, "wb") as f:
        f.write(bytes(out))


def write_wav(path: str, pcm: np.ndarray, sample_rate: int) -> None:
    """16-bit mono PCM samples as a RIFF/WAVE file."""
    data = np.ascontiguousarray(pcm, "<i2").tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(data), b"WAVE"))
        f.write(struct.pack("<4sI", b"fmt ", 16))
        f.write(struct.pack("<HHIIHH", 1, 1, sample_rate, sample_rate * 2,
                            2, 16))
        f.write(struct.pack("<4sI", b"data", len(data)))
        f.write(data)


def write_lab(path: str, labs_s: np.ndarray) -> None:
    """VAD speech regions, one 'start end speech' line each (seconds)."""
    with open(path, "w") as f:
        for a, b in labs_s:
            f.write(f"{a:.2f} {b:.2f} speech\n")


def read_vec_ark(path: str) -> Dict[str, np.ndarray]:
    """{key: float32 vector} of a Kaldi binary ark of float vectors."""
    out = {}
    with open(path, "rb") as f:
        buf = f.read()
    p = 0
    while p < len(buf):
        sp = buf.index(b" ", p)
        key = buf[p:sp].decode()
        if buf[sp + 1:sp + 7] != b"\x00BFV \x04":
            raise ValueError(f"{path}: not a float vector at {key!r}")
        (n,) = struct.unpack("<i", buf[sp + 7:sp + 11])
        out[key] = np.frombuffer(buf, np.float32, n, sp + 11).copy()
        p = sp + 11 + 4 * n
    return out


def read_segments(path: str):
    """[(name, recording, start, end)] of a segments file."""
    with open(path) as f:
        return [(p[0], p[1], float(p[2]), float(p[3]))
                for p in (line.split() for line in f) if p]
