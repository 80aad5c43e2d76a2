"""Minimal HDF5 codec for flat files of numeric datasets, in numpy alone.

The x-vector transform ships as an HDF5 file (transform.h5: datasets
mean1, lda, mean2 in the root group). io.transform reads it with
`read_datasets` here on every machine (the CUDA machines the port runs on
need not have h5py), and `write_datasets` writes such files (h5py and
libhdf5 read them; tests/test_torch_io.py checks both ways).

Covered: the layout h5py writes by default — superblock version 0 or 1
(after a user block or not), a root group held in a symbol table (v1
B-tree, symbol nodes, local heap), version-1 object headers (continuation
blocks and attributes included), contiguous or compact little/big-endian
IEEE float and integer datasets. Anything else — h5py's libver='latest'
layouts (superblock 2/3, version-2 object headers, link messages) and
chunked or compressed datasets — raises ValueError naming what is
missing. The VBx model's transform.h5 has not been read by this reader
yet: tests/test_torch_io.py compares it with h5py where that asset is
mounted.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

_SIG = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
# message types
_DATASPACE, _DATATYPE, _FILL, _LAYOUT, _CONT, _STAB = 1, 3, 5, 8, 16, 17


# -- reading -------------------------------------------------------------


class _Reader:
    def __init__(self, buf: bytes):
        self.b = buf
        # the superblock sits at 0 or after a user block of 512 * 2^k bytes
        sb = 0
        while buf[sb:sb + 8] != _SIG:
            sb = 512 if sb == 0 else 2 * sb
            if sb >= len(buf):
                raise ValueError("not an HDF5 file (bad signature)")
        ver = buf[sb + 8]
        if ver not in (0, 1):
            raise ValueError(f"HDF5 superblock version {ver} is not "
                             f"supported by this reader")
        so, sl = buf[sb + 13], buf[sb + 14]          # sizes of offsets/lengths
        if (so, sl) != (8, 8):
            raise ValueError("only 8-byte HDF5 offsets/lengths supported")
        p = sb + 24 + (4 if ver == 1 else 0)
        self.base = self._u(p, 8)                    # absolute file address
        # root group symbol table entry follows the four addresses
        self.root = p + 32

    def _u(self, p: int, n: int) -> int:
        return int.from_bytes(self.b[p:p + n], "little")

    def _messages(self, addr: int):
        """(type, data bytes) of every message of a v1 object header."""
        b = self.b
        if b[addr:addr + 4] == b"OHDR":
            raise ValueError("version-2 HDF5 object headers are not "
                             "supported by this reader")
        if b[addr] != 1:
            raise ValueError(f"object header version {b[addr]} is not "
                             f"supported by this reader")
        n_msgs = self._u(addr + 2, 2)
        chunks = [(addr + 16, self._u(addr + 8, 4))]
        out = []
        while chunks and len(out) < n_msgs:
            p, size = chunks.pop(0)
            end = p + size
            while p + 8 <= end and len(out) < n_msgs:
                mtype, msize = self._u(p, 2), self._u(p + 2, 2)
                data = b[p + 8:p + 8 + msize]
                if mtype == _CONT:
                    chunks.append((self.base + int.from_bytes(data[:8],
                                                              "little"),
                                   int.from_bytes(data[8:16], "little")))
                out.append((mtype, data))
                p += 8 + msize
        return out

    def _heap_string(self, heap: int, off: int) -> str:
        if self.b[heap:heap + 4] != b"HEAP":
            raise ValueError("bad local heap signature")
        data = self.base + self._u(heap + 24, 8)
        end = self.b.index(b"\0", data + off)
        return self.b[data + off:end].decode()

    def _group_entries(self, btree: int, heap: int):
        """{name: object header address} of a symbol-table group."""
        b = self.b
        if b[btree:btree + 4] != b"TREE" or b[btree + 4] != 0:
            raise ValueError("bad group B-tree node")
        level, used = b[btree + 5], self._u(btree + 6, 2)
        out = {}
        p = btree + 24 + 8                      # first child after key 0
        for _ in range(used):
            child = self.base + self._u(p, 8)
            if level > 0:
                out.update(self._group_entries(child, heap))
            else:
                if b[child:child + 4] != b"SNOD":
                    raise ValueError("bad symbol table node")
                for i in range(self._u(child + 6, 2)):
                    e = child + 8 + 40 * i
                    name = self._heap_string(heap, self._u(e, 8))
                    out[name] = self.base + self._u(e + 8, 8)
            p += 16
        return out

    def _dataset(self, addr: int) -> np.ndarray:
        shape = dtype = data = None
        for mtype, d in self._messages(addr):
            if mtype == _DATASPACE:
                ndim = d[1]
                off = 8 if d[0] == 1 else 4
                shape = tuple(int.from_bytes(d[off + 8 * i:off + 8 * i + 8],
                                             "little") for i in range(ndim))
            elif mtype == _DATATYPE:
                cls, size = d[0] & 0x0F, int.from_bytes(d[4:8], "little")
                order = ">" if d[1] & 1 else "<"
                if cls == 1:
                    kind = "f"
                elif cls == 0:
                    kind = "i" if d[1] & 0x08 else "u"
                else:
                    raise ValueError(f"HDF5 datatype class {cls} is not "
                                     f"supported by this reader")
                dtype = np.dtype(f"{order}{kind}{size}")
            elif mtype == _LAYOUT:
                if d[0] != 3:
                    raise ValueError(f"HDF5 layout version {d[0]} is not "
                                     f"supported by this reader")
                if d[1] == 1:                       # contiguous
                    a = int.from_bytes(d[2:10], "little")
                    n = int.from_bytes(d[10:18], "little")
                    data = (b"" if a == _UNDEF
                            else self.b[self.base + a:self.base + a + n])
                elif d[1] == 0:                     # compact
                    n = int.from_bytes(d[2:4], "little")
                    data = d[4:4 + n]
                else:
                    raise ValueError("chunked HDF5 datasets are not "
                                     "supported by this reader")
        if shape is None or dtype is None or data is None:
            raise ValueError("incomplete HDF5 dataset header")
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(data, dtype=dtype, count=count) if data else \
            np.zeros(count, dtype)
        return arr.reshape(shape).astype(dtype.newbyteorder("="))

    def datasets(self) -> Dict[str, np.ndarray]:
        r = self.root
        cache = self._u(r + 16, 4)
        if cache == 1:
            btree, heap = self._u(r + 24, 8), self._u(r + 32, 8)
        else:
            msgs = dict(self._messages(self.base + self._u(r + 8, 8)))
            if _STAB not in msgs:
                raise ValueError("root group has no symbol table")
            btree = int.from_bytes(msgs[_STAB][:8], "little")
            heap = int.from_bytes(msgs[_STAB][8:16], "little")
        entries = self._group_entries(self.base + btree, self.base + heap)
        return {k: self._dataset(a) for k, a in sorted(entries.items())}


def read_datasets(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of the root group's datasets."""
    with open(path, "rb") as f:
        return _Reader(f.read()).datasets()


# -- writing -------------------------------------------------------------


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
