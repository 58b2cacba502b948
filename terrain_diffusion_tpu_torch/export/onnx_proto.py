"""Minimal first-party ONNX protobuf writer/reader (no `onnx` dependency).

The port's own copy of ``terrain_diffusion_tpu.export.onnx_proto``: the
same wire format and schema subset, so the two packages write the same
bytes for the same graph.  The game-mod consumers of the reference
framework load `.onnx` files (reference `onnx/export.py:24-250`).  ONNX
files are plain protobuf messages, so this module implements the protobuf
wire format directly (varint / 32-bit / length-delimited encodings) plus
the subset of the ONNX schema needed to describe inference graphs:

    ModelProto, GraphProto, NodeProto, AttributeProto, TensorProto,
    ValueInfoProto, TypeProto(.Tensor), TensorShapeProto(.Dimension),
    OperatorSetIdProto, StringStringEntryProto

Field numbers and enum values are transcribed from the public ONNX schema
(`onnx/onnx.proto`, IR version 8 / opset 17 era); they are frozen by
protobuf compatibility rules, so any compliant ONNX runtime parses files
produced here.  Packed encoding is used for repeated scalars - required by
proto3 and accepted by every proto2 parser per the protobuf spec.

The reader exists so the numpy reference runtime (`onnx_ref_runtime.py`)
and the tests can round-trip exported files without external tooling.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Wire-format primitives
# ---------------------------------------------------------------------------

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


def _varint(value: int) -> bytes:
    if value < 0:  # two's complement, 64-bit (protobuf int64 semantics)
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    if result >= 1 << 63:  # negative int64
        result -= 1 << 64
    return result, pos


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, _WIRE_LEN) + _varint(len(payload)) + payload


# ---------------------------------------------------------------------------
# Generic table-driven message base
# ---------------------------------------------------------------------------
# FIELDS: {field_number: (attr_name, kind, repeated)} where kind is one of
#   'int'    — varint (int64/int32/enum/bool)
#   'float'  — 32-bit float
#   'string' — UTF-8 length-delimited
#   'bytes'  — raw length-delimited
#   a Message subclass — embedded message
# Repeated scalar ints/floats are written packed; the reader accepts both
# packed and unpacked forms (spec requirement for packable fields).


class Message:
    FIELDS: Dict[int, Tuple[str, Any, bool]] = {}

    def __init__(self, **kwargs):
        for _num, (name, _kind, repeated) in self.FIELDS.items():
            setattr(self, name, [] if repeated else None)
        for key, value in kwargs.items():
            if not any(name == key for name, _k, _r in self.FIELDS.values()):
                raise AttributeError(f"{type(self).__name__} has no field {key!r}")
            setattr(self, key, value)

    # -- encode ------------------------------------------------------------
    def encode(self) -> bytes:
        out = bytearray()
        for num in sorted(self.FIELDS):
            name, kind, repeated = self.FIELDS[num]
            value = getattr(self, name)
            if value is None or (repeated and len(value) == 0):
                continue
            if repeated:
                if kind == "int":
                    payload = b"".join(_varint(int(v)) for v in value)
                    out += _len_delim(num, payload)  # packed
                elif kind == "float":
                    out += _len_delim(num, struct.pack(f"<{len(value)}f", *value))
                elif kind in ("string", "bytes"):
                    for v in value:
                        data = v.encode() if isinstance(v, str) else v
                        out += _len_delim(num, data)
                else:  # message
                    for v in value:
                        out += _len_delim(num, v.encode())
            else:
                if kind == "int":
                    out += _tag(num, _WIRE_VARINT) + _varint(int(value))
                elif kind == "float":
                    out += _tag(num, _WIRE_32BIT) + struct.pack("<f", value)
                elif kind in ("string", "bytes"):
                    data = value.encode() if isinstance(value, str) else value
                    out += _len_delim(num, data)
                else:
                    out += _len_delim(num, value.encode())
        return bytes(out)

    # -- decode ------------------------------------------------------------
    @classmethod
    def decode(cls, buf: bytes) -> "Message":
        msg = cls()
        pos = 0
        while pos < len(buf):
            key, pos = _read_varint(buf, pos)
            field, wire = key >> 3, key & 7
            spec = cls.FIELDS.get(field)
            if wire == _WIRE_VARINT:
                value, pos = _read_varint(buf, pos)
            elif wire == _WIRE_64BIT:
                value = struct.unpack_from("<d", buf, pos)[0]
                pos += 8
            elif wire == _WIRE_32BIT:
                value = struct.unpack_from("<f", buf, pos)[0]
                pos += 4
            elif wire == _WIRE_LEN:
                length, pos = _read_varint(buf, pos)
                value = buf[pos : pos + length]
                pos += length
            else:
                raise ValueError(f"unsupported wire type {wire}")
            if spec is None:  # unknown field: skip
                continue
            name, kind, repeated = spec
            if kind == "int" and wire == _WIRE_LEN:  # packed ints
                vals, p = [], 0
                while p < len(value):
                    v, p = _read_varint(value, p)
                    vals.append(v)
                getattr(msg, name).extend(vals)
                continue
            if kind == "float" and wire == _WIRE_LEN:  # packed floats
                vals = list(struct.unpack(f"<{len(value) // 4}f", value))
                getattr(msg, name).extend(vals)
                continue
            if kind == "string":
                value = value.decode("utf-8") if isinstance(value, bytes) else value
            elif isinstance(kind, type) and issubclass(kind, Message):
                value = kind.decode(value)
            if repeated:
                getattr(msg, name).append(value)
            else:
                setattr(msg, name, value)
        return msg

    def __repr__(self):
        parts = []
        for _num, (name, _kind, repeated) in sorted(self.FIELDS.items()):
            v = getattr(self, name)
            if v is None or (repeated and not v):
                continue
            parts.append(f"{name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


# ---------------------------------------------------------------------------
# ONNX schema subset (field numbers per public onnx/onnx.proto)
# ---------------------------------------------------------------------------

# TensorProto.DataType values
FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64 = 1, 2, 3, 4, 5, 6, 7
STRING, BOOL, FLOAT16, DOUBLE, UINT32, UINT64 = 8, 9, 10, 11, 12, 13
BFLOAT16 = 16

_NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.float64): DOUBLE,
    np.dtype(np.float16): FLOAT16,
    np.dtype(np.int64): INT64,
    np.dtype(np.int32): INT32,
    np.dtype(np.int16): INT16,
    np.dtype(np.int8): INT8,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.bool_): BOOL,
}
_ONNX_TO_NP = {v: k for k, v in _NP_TO_ONNX.items()}


# AttributeProto.AttributeType values
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_GRAPH, ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 5, 6, 7, 8


class TensorProto(Message):
    FIELDS = {
        1: ("dims", "int", True),
        2: ("data_type", "int", False),
        4: ("float_data", "float", True),
        7: ("int64_data", "int", True),
        8: ("name", "string", False),
        9: ("raw_data", "bytes", False),
        12: ("doc_string", "string", False),
    }


class AttributeProto(Message):
    FIELDS = {
        1: ("name", "string", False),
        2: ("f", "float", False),
        3: ("i", "int", False),
        4: ("s", "bytes", False),
        5: ("t", TensorProto, False),
        7: ("floats", "float", True),
        8: ("ints", "int", True),
        9: ("strings", "bytes", True),
        13: ("doc_string", "string", False),
        20: ("type", "int", False),
    }


class Dimension(Message):
    FIELDS = {
        1: ("dim_value", "int", False),
        2: ("dim_param", "string", False),
    }


class TensorShapeProto(Message):
    FIELDS = {1: ("dim", Dimension, True)}


class TypeProtoTensor(Message):
    FIELDS = {
        1: ("elem_type", "int", False),
        2: ("shape", TensorShapeProto, False),
    }


class TypeProto(Message):
    FIELDS = {1: ("tensor_type", TypeProtoTensor, False)}


class ValueInfoProto(Message):
    FIELDS = {
        1: ("name", "string", False),
        2: ("type", TypeProto, False),
        3: ("doc_string", "string", False),
    }


class NodeProto(Message):
    FIELDS = {
        1: ("input", "string", True),
        2: ("output", "string", True),
        3: ("name", "string", False),
        4: ("op_type", "string", False),
        5: ("attribute", AttributeProto, True),
        6: ("doc_string", "string", False),
        7: ("domain", "string", False),
    }


class GraphProto(Message):
    FIELDS = {
        1: ("node", NodeProto, True),
        2: ("name", "string", False),
        5: ("initializer", TensorProto, True),
        10: ("doc_string", "string", False),
        11: ("input", ValueInfoProto, True),
        12: ("output", ValueInfoProto, True),
        13: ("value_info", ValueInfoProto, True),
    }


class OperatorSetIdProto(Message):
    FIELDS = {
        1: ("domain", "string", False),
        2: ("version", "int", False),
    }


class StringStringEntryProto(Message):
    FIELDS = {
        1: ("key", "string", False),
        2: ("value", "string", False),
    }


class ModelProto(Message):
    FIELDS = {
        1: ("ir_version", "int", False),
        2: ("producer_name", "string", False),
        3: ("producer_version", "string", False),
        4: ("domain", "string", False),
        5: ("model_version", "int", False),
        6: ("doc_string", "string", False),
        7: ("graph", GraphProto, False),
        8: ("opset_import", OperatorSetIdProto, True),
        14: ("metadata_props", StringStringEntryProto, True),
    }


# ---------------------------------------------------------------------------
# numpy <-> TensorProto
# ---------------------------------------------------------------------------

# Protobuf cannot serialize any single message >2^31-1 bytes (hard limit in
# every protobuf parser, including onnxruntime's); ONNX handles bigger
# weights via external data files.  Rather than silently emit a file no
# consumer can parse, refuse with a clear error.
_PROTO_SIZE_LIMIT = (1 << 31) - 1


def tensor_from_numpy(arr: np.ndarray, name: str) -> TensorProto:
    arr = np.asarray(arr)
    if arr.nbytes > _PROTO_SIZE_LIMIT:
        raise ValueError(
            f"initializer {name!r} is {arr.nbytes} bytes; protobuf caps "
            f"messages at {_PROTO_SIZE_LIMIT} bytes — split the tensor or "
            "use ONNX external data")
    shape = arr.shape  # before ascontiguousarray: it promotes 0-d to 1-d
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _NP_TO_ONNX:
        raise TypeError(f"unsupported dtype {arr.dtype}")
    return TensorProto(
        name=name,
        dims=list(shape),
        data_type=_NP_TO_ONNX[arr.dtype],
        raw_data=arr.astype(arr.dtype.newbyteorder("<")).tobytes(),
    )


def tensor_to_numpy(t: TensorProto) -> np.ndarray:
    dtype = _ONNX_TO_NP.get(t.data_type)
    if dtype is None:
        raise TypeError(f"unsupported ONNX data_type {t.data_type}")
    shape = tuple(t.dims or [])
    if t.raw_data:
        arr = np.frombuffer(t.raw_data, dtype=dtype.newbyteorder("<"))
        return arr.astype(dtype).reshape(shape)
    if t.float_data:
        return np.asarray(t.float_data, dtype=np.float32).astype(dtype).reshape(shape)
    if t.int64_data:
        return np.asarray(t.int64_data, dtype=np.int64).astype(dtype).reshape(shape)
    return np.zeros(shape, dtype=dtype)


def make_attribute(name: str, value) -> AttributeProto:
    """Build an AttributeProto from a Python value (type inferred)."""
    if isinstance(value, bool):
        return AttributeProto(name=name, i=int(value), type=ATTR_INT)
    if isinstance(value, int):
        return AttributeProto(name=name, i=value, type=ATTR_INT)
    if isinstance(value, float):
        return AttributeProto(name=name, f=value, type=ATTR_FLOAT)
    if isinstance(value, str):
        return AttributeProto(name=name, s=value.encode(), type=ATTR_STRING)
    if isinstance(value, TensorProto):
        return AttributeProto(name=name, t=value, type=ATTR_TENSOR)
    if isinstance(value, (list, tuple)):
        if all(isinstance(v, int) for v in value):
            return AttributeProto(name=name, ints=list(value), type=ATTR_INTS)
        if all(isinstance(v, (int, float)) for v in value):
            return AttributeProto(name=name, floats=[float(v) for v in value],
                                  type=ATTR_FLOATS)
        if all(isinstance(v, str) for v in value):
            return AttributeProto(name=name, strings=[v.encode() for v in value],
                                  type=ATTR_STRINGS)
    raise TypeError(f"cannot infer attribute type for {name}={value!r}")


def attribute_value(attr: AttributeProto):
    """Extract the Python value of an AttributeProto."""
    if attr.type == ATTR_INT:
        return int(attr.i or 0)
    if attr.type == ATTR_FLOAT:
        return float(attr.f or 0.0)
    if attr.type == ATTR_STRING:
        return (attr.s or b"").decode()
    if attr.type == ATTR_INTS:
        return [int(v) for v in attr.ints]
    if attr.type == ATTR_FLOATS:
        return [float(v) for v in attr.floats]
    if attr.type == ATTR_STRINGS:
        return [v.decode() for v in attr.strings]
    if attr.type == ATTR_TENSOR:
        return tensor_to_numpy(attr.t)
    raise TypeError(f"unsupported attribute type {attr.type}")


def value_info(name: str, elem_type: int, shape) -> ValueInfoProto:
    """shape entries: int (static), str (dim_param) or None (unknown)."""
    dims = []
    for d in shape:
        if isinstance(d, str):
            dims.append(Dimension(dim_param=d))
        elif d is None:
            dims.append(Dimension())
        else:
            dims.append(Dimension(dim_value=int(d)))
    return ValueInfoProto(
        name=name,
        type=TypeProto(tensor_type=TypeProtoTensor(
            elem_type=elem_type, shape=TensorShapeProto(dim=dims))),
    )


def load_model(path: str) -> ModelProto:
    with open(path, "rb") as f:
        return ModelProto.decode(f.read())


def save_model(model: ModelProto, path: str) -> None:
    data = model.encode()
    if len(data) > _PROTO_SIZE_LIMIT:
        raise ValueError(
            f"serialized model is {len(data)} bytes; protobuf caps messages "
            f"at {_PROTO_SIZE_LIMIT} bytes — use ONNX external data")
    with open(path, "wb") as f:
        f.write(data)
