"""First-party ONNX model reader (no onnx/onnxruntime dependency).

The reference's example recipe runs its extractor through onnxruntime
(`VBx/predict.py:126-129`, `run_example.sh:13-20` with final.onnx, itself an
export of the released torch ResNet101 checkpoint). The port runs the
model as its own torch module, so ONNX support here means *weight import*,
with neither the `onnx` package nor onnxruntime: parse the ONNX file (a
protobuf) directly at the wire-format level and recover the initializer
tensors and graph structure; `models/onnx_import.py` maps them onto the
port's ResNet state dict. A copy of vbx_tpu's reader.

Only the ModelProto subset an exported inference CNN uses is decoded:
graph nodes (op_type / inputs / outputs / attributes), initializers
(name / dims / dtype / payload), graph inputs/outputs, opset imports.
Field numbers follow onnx/onnx.proto (ModelProto.graph=7,
GraphProto.{node=1,initializer=5,input=11,output=12},
NodeProto.{input=1,output=2,name=3,op_type=4,attribute=5},
TensorProto.{dims=1,data_type=2,float_data=4,int64_data=7,name=8,
raw_data=9,double_data=10}, AttributeProto.{name=1,f=2,i=3,s=4,t=5,
floats=7,ints=8,type=20}).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

# TensorProto.DataType -> numpy dtype (the subset CNN exports use)
_DTYPES = {
    1: np.dtype("<f4"),    # FLOAT
    2: np.dtype("u1"),     # UINT8
    3: np.dtype("i1"),     # INT8
    6: np.dtype("<i4"),    # INT32
    7: np.dtype("<i8"),    # INT64
    9: np.dtype("?"),      # BOOL
    10: np.dtype("<f2"),   # FLOAT16
    11: np.dtype("<f8"),   # DOUBLE
}


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Iterate (field_number, wire_type, value) over a serialized message.

    Length-delimited values are returned as bytes; varints/fixed as ints.
    """
    i, n = 0, len(buf)
    while i < n:
        tag = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            tag |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:          # varint
            val = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                val |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
        elif wtype == 1:        # fixed64
            val = struct.unpack_from("<Q", buf, i)[0]
            i += 8
        elif wtype == 2:        # length-delimited
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            val = buf[i:i + ln]
            i += ln
        elif wtype == 5:        # fixed32
            val = struct.unpack_from("<I", buf, i)[0]
            i += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wtype}")
        yield fnum, wtype, val


def _zigzag_ok_int64(v: int) -> int:
    """Protobuf int64 varints are two's-complement; fold back to signed."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed_varints(buf: bytes) -> List[int]:
    out = []
    i, n = 0, len(buf)
    while i < n:
        val = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            val |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        out.append(_zigzag_ok_int64(val))
    return out


@dataclass
class OnnxTensor:
    name: str = ""
    dims: Tuple[int, ...] = ()
    data_type: int = 0
    array: np.ndarray = field(default_factory=lambda: np.empty(0))


@dataclass
class OnnxNode:
    op_type: str = ""
    name: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class OnnxGraph:
    nodes: List[OnnxNode] = field(default_factory=list)
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    name: str = ""


@dataclass
class OnnxModel:
    graph: OnnxGraph
    ir_version: int = 0
    opsets: Dict[str, int] = field(default_factory=dict)
    producer: str = ""


def _parse_tensor(buf: bytes) -> OnnxTensor:
    t = OnnxTensor()
    dims: List[int] = []
    floats: List[bytes] = []
    int32s: List[int] = []
    int64s: List[int] = []
    doubles: List[bytes] = []
    raw = b""
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            if wtype == 0:
                dims.append(_zigzag_ok_int64(val))
            else:               # packed repeated
                dims.extend(_packed_varints(val))
        elif fnum == 2:
            t.data_type = val
        elif fnum == 4:         # float_data (packed fixed32 floats)
            floats.append(val if wtype == 2 else struct.pack("<I", val))
        elif fnum == 5:         # int32_data (varints, packed or not)
            if wtype == 2:
                int32s.extend(_packed_varints(val))
            else:
                int32s.append(_zigzag_ok_int64(val))
        elif fnum == 7:         # int64_data
            if wtype == 2:
                int64s.extend(_packed_varints(val))
            else:
                int64s.append(_zigzag_ok_int64(val))
        elif fnum == 8:
            t.name = val.decode()
        elif fnum == 9:
            raw = val
        elif fnum == 10:        # double_data (packed fixed64)
            doubles.append(val if wtype == 2 else struct.pack("<Q", val))
        elif fnum == 13:
            raise ValueError(
                f"initializer {t.name!r} uses external data; not supported")
    t.dims = tuple(dims)
    dt = _DTYPES.get(t.data_type)
    if dt is None:
        raise ValueError(
            f"initializer {t.name!r}: unsupported data_type {t.data_type}")
    if raw:
        arr = np.frombuffer(raw, dtype=dt)
    elif floats:
        arr = np.frombuffer(b"".join(floats), dtype="<f4").astype(dt)
    elif doubles:
        arr = np.frombuffer(b"".join(doubles), dtype="<f8").astype(dt)
    elif int64s:
        arr = np.asarray(int64s, dtype=dt)
    elif int32s:
        if dt == np.dtype("<f2"):
            # FLOAT16 rides int32_data as raw uint16 bit patterns
            # (onnx.proto TensorProto.int32_data docs), not as values
            arr = np.asarray(int32s, dtype="<u2").view("<f2")
        else:
            arr = np.asarray(int32s, dtype=dt)
    else:
        arr = np.empty(0, dtype=dt)
    t.array = arr.reshape(t.dims) if t.dims else arr
    return t


def _parse_attr(buf: bytes) -> Tuple[str, Any]:
    name = ""
    atype = 0
    f_val = i_val = s_val = t_val = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 2:
            f_val = struct.unpack("<f", struct.pack("<I", val))[0]
        elif fnum == 3:
            i_val = _zigzag_ok_int64(val)
        elif fnum == 4:
            s_val = val
        elif fnum == 5:
            t_val = _parse_tensor(val)
        elif fnum == 7:
            if wtype == 2:
                floats.extend(np.frombuffer(val, dtype="<f4").tolist())
            else:
                floats.append(struct.unpack("<f", struct.pack("<I", val))[0])
        elif fnum == 8:
            if wtype == 2:
                ints.extend(_packed_varints(val))
            else:
                ints.append(_zigzag_ok_int64(val))
        elif fnum == 9:
            strings.append(val)
        elif fnum == 20:
            atype = val
    # AttributeProto.AttributeType: 1=FLOAT 2=INT 3=STRING 4=TENSOR
    # 6=FLOATS 7=INTS 8=STRINGS
    if atype == 1:
        return name, f_val
    if atype == 2:
        return name, i_val
    if atype == 3:
        return name, (s_val or b"").decode(errors="replace")
    if atype == 4:
        return name, t_val
    if atype == 6:
        return name, floats
    if atype == 7:
        return name, ints
    if atype == 8:
        return name, [s.decode(errors="replace") for s in strings]
    # untyped fallback: first populated scalar wins
    for v in (t_val, s_val, i_val, f_val, ints or None, floats or None):
        if v is not None:
            return name, v
    return name, None


def _parse_node(buf: bytes) -> OnnxNode:
    n = OnnxNode()
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            n.inputs.append(val.decode())
        elif fnum == 2:
            n.outputs.append(val.decode())
        elif fnum == 3:
            n.name = val.decode()
        elif fnum == 4:
            n.op_type = val.decode()
        elif fnum == 5:
            k, v = _parse_attr(val)
            n.attrs[k] = v
    return n


def _value_info_name(buf: bytes) -> str:
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            return val.decode()
    return ""


def _parse_graph(buf: bytes) -> OnnxGraph:
    g = OnnxGraph()
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            g.nodes.append(_parse_node(val))
        elif fnum == 2:
            g.name = val.decode()
        elif fnum == 5:
            t = _parse_tensor(val)
            g.initializers[t.name] = t.array
        elif fnum == 11:
            g.inputs.append(_value_info_name(val))
        elif fnum == 12:
            g.outputs.append(_value_info_name(val))
    return g


def read_onnx(path: str) -> OnnxModel:
    """Parse an ONNX ModelProto file into graph + weight arrays."""
    with open(path, "rb") as f:
        buf = f.read()
    graph = OnnxGraph()
    ir_version = 0
    opsets: Dict[str, int] = {}
    producer = ""
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            ir_version = val
        elif fnum == 2:
            producer = val.decode()
        elif fnum == 7:
            graph = _parse_graph(val)
        elif fnum == 8:
            dom, ver = "", 0
            for f2, _, v2 in _fields(val):
                if f2 == 1:
                    dom = v2.decode()
                elif f2 == 2:
                    ver = v2
            opsets[dom] = ver
    # graph "inputs" in ONNX include initializers for old IR versions;
    # keep only true runtime inputs
    graph.inputs = [n for n in graph.inputs if n not in graph.initializers]
    return OnnxModel(graph=graph, ir_version=ir_version, opsets=opsets,
                     producer=producer)
