"""The protobuf wire format of the ONNX messages, written by hand.

Counterpart of ``diffsvc_tpu/onnx/proto.py`` + ``onnx_pb2.py`` without
``google.protobuf``: the messages of the JAX package's ``onnx.proto`` (a
subset of the public ONNX schema, proto3, with the original field
numbers), with the part of protobuf's Python message API that the builder,
the runtime and the chain tool use: attribute access, ``add``/``append``/
``extend`` on repeated fields, ``CopyFrom``, ``SerializeToString`` and
``ParseFromString``.

Encoding follows proto3: fields in field-number order; scalars equal to
their default are left out unless they belong to a ``oneof``; a singular
message is written when any of its fields was set; repeated numbers are
packed; ``int32``/``int64``/enum are plain varints (negatives as 10-byte
two's complement, as ONNX uses no ``sint`` fields).  The decoder also reads
unpacked repeated numbers and skips fields it does not know, so files of
other ONNX writers parse.  ``tests/test_torch_onnx.py`` holds the field
tables against ``onnx_pb2``'s descriptor and the bytes against protobuf's.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional

# TensorProto.DataType values (ONNX spec), as diffsvc_tpu/onnx/proto.py.
FLOAT = 1
UINT8 = 2
INT8 = 3
INT16 = 5
INT32 = 6
INT64 = 7
BOOL = 9
FLOAT16 = 10
DOUBLE = 11
UINT32 = 12
UINT64 = 13
BFLOAT16 = 16

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5
_MASK64 = (1 << 64) - 1
_INTS = {"int64", "int32", "uint64", "enum"}
_NUMERIC = _INTS | {"float", "double"}
_DEFAULTS = {"int64": 0, "int32": 0, "uint64": 0, "enum": 0, "float": 0.0,
             "double": 0.0, "string": "", "bytes": b""}


class Field(NamedTuple):
    number: int
    kind: str       # int64 int32 uint64 enum float double string bytes msg
    repeated: bool = False
    msg: Optional[str] = None  # the message class's name, for kind "msg"
    oneof: Optional[str] = None


# ---------------------------------------------------------------------------
# varints and tags
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    v &= _MASK64
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _read_varint(buf, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _tag(number: int, wire: int) -> bytes:
    return _varint((number << 3) | wire)


def _f32(v) -> float:
    """``v`` rounded to float32, as protobuf stores a ``float`` field."""
    return struct.unpack("<f", struct.pack("<f", float(v)))[0]


def _encode_scalar(kind: str, v) -> bytes:
    if kind in _INTS:
        return _varint(int(v))
    if kind == "float":
        return struct.pack("<f", float(v))
    if kind == "double":
        return struct.pack("<d", float(v))
    raise TypeError(kind)


def _wire(kind: str) -> int:
    return {"float": _I32, "double": _I64}.get(kind, _VARINT)


def _decode_scalar(kind: str, wire: int, buf, pos: int):
    if wire == _VARINT:
        v, pos = _read_varint(buf, pos)
        if kind == "uint64":
            return v, pos
        return (_signed(v, 64) if kind == "int64" else _signed(v, 32)), pos
    if wire == _I32:
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if wire == _I64:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    raise ValueError(f"wire type {wire} for a {kind} field")


def _skip(wire: int, buf, pos: int) -> int:
    if wire == _VARINT:
        return _read_varint(buf, pos)[1]
    if wire == _I64:
        return pos + 8
    if wire == _I32:
        return pos + 4
    if wire == _LEN:
        n, pos = _read_varint(buf, pos)
        return pos + n
    raise ValueError(f"unsupported wire type {wire}")


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------

class _Repeated(list):
    """A repeated scalar field: a list that marks its message as set."""

    def __init__(self, owner: "Message", kind: str):
        super().__init__()
        self._owner = owner
        self._kind = kind

    def _conv(self, v):
        return _f32(v) if self._kind == "float" else v

    def append(self, v):
        super().append(self._conv(v))
        self._owner._touch()

    def extend(self, vs):
        super().extend(self._conv(v) for v in vs)
        self._owner._touch()


class _RepeatedMsg(list):
    """A repeated message field."""

    def __init__(self, owner: "Message", cls):
        super().__init__()
        self._owner = owner
        self._cls = cls

    def add(self) -> "Message":
        m = self._cls()
        object.__setattr__(m, "_parent", self._owner)
        super().append(m)
        self._owner._touch()
        return m

    def append(self, m: "Message"):
        object.__setattr__(m, "_parent", self._owner)
        super().append(m)
        self._owner._touch()

    def extend(self, ms):
        for m in ms:
            self.append(m)


class Message:
    """Base of the message classes: ``_fields`` maps a field name to its
    :class:`Field`."""

    _fields: dict = {}
    _by_number: dict = {}
    _ordered: list = []

    def __init__(self):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_parent", None)
        object.__setattr__(self, "_present", False)

    def _touch(self):
        m = self
        while m is not None and not m._present:
            object.__setattr__(m, "_present", True)
            m = m._parent

    def __getattr__(self, name):
        f = type(self)._fields.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        vals = self._values
        if name not in vals:
            if f.repeated:
                vals[name] = (_RepeatedMsg(self, _CLASSES[f.msg])
                              if f.kind == "msg" else _Repeated(self, f.kind))
            elif f.kind == "msg":
                m = _CLASSES[f.msg]()
                object.__setattr__(m, "_parent", self)
                vals[name] = m
            else:
                return _DEFAULTS[f.kind]
        return vals[name]

    def __setattr__(self, name, value):
        f = type(self)._fields.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        if f.repeated or f.kind == "msg":
            raise AttributeError(f"assignment to the {f.kind} field {name!r}; "
                                 "use add/append/extend or CopyFrom")
        if f.kind == "string" and not isinstance(value, str):
            raise TypeError(f"{name} takes a str")
        if f.kind == "bytes" and not isinstance(value, (bytes, bytearray)):
            raise TypeError(f"{name} takes bytes")
        if f.kind == "float":
            value = _f32(value)
        elif f.kind in _INTS:
            value = int(value)
        if f.oneof is not None:
            for other, g in type(self)._fields.items():
                if g.oneof == f.oneof and other != name:
                    self._values.pop(other, None)
        self._values[name] = value
        self._touch()

    def _has(self, name, f) -> bool:
        if name not in self._values:
            return False
        v = self._values[name]
        if f.repeated:
            return len(v) > 0
        if f.kind == "msg":
            return v._present
        return f.oneof is not None or v != _DEFAULTS[f.kind]

    def CopyFrom(self, other: "Message") -> None:
        if type(other) is not type(self):
            raise TypeError(f"CopyFrom {type(other).__name__} into "
                            f"{type(self).__name__}")
        self._values.clear()
        for name, f in type(self)._fields.items():
            if name not in other._values:
                continue
            v = other._values[name]
            if f.kind == "msg" and f.repeated:
                dst = getattr(self, name)
                for m in v:
                    dst.add().CopyFrom(m)
            elif f.kind == "msg":
                if v._present:
                    getattr(self, name).CopyFrom(v)
            elif f.repeated:
                getattr(self, name).extend(v)
            else:
                self._values[name] = v
        self._touch()

    # --- encoding ---------------------------------------------------------

    def SerializeToString(self) -> bytes:
        out = bytearray()
        self._encode(out)
        return bytes(out)

    def _encode(self, out: bytearray) -> None:
        for name, f in type(self)._ordered:
            if not self._has(name, f):
                continue
            v = self._values[name]
            if f.kind == "msg":
                for m in (v if f.repeated else (v,)):
                    body = m.SerializeToString()
                    out += _tag(f.number, _LEN) + _varint(len(body)) + body
            elif f.repeated and f.kind in _NUMERIC:
                body = b"".join(_encode_scalar(f.kind, x) for x in v)
                out += _tag(f.number, _LEN) + _varint(len(body)) + body
            else:
                for x in (v if f.repeated else (v,)):
                    if f.kind in ("string", "bytes"):
                        raw = x.encode("utf-8") if f.kind == "string" else x
                        out += _tag(f.number, _LEN) + _varint(len(raw))
                        out += raw
                    else:
                        out += _tag(f.number, _wire(f.kind))
                        out += _encode_scalar(f.kind, x)

    # --- decoding ---------------------------------------------------------

    def ParseFromString(self, data) -> int:
        self._values.clear()
        buf = memoryview(data)
        self._decode(buf, 0, len(buf))
        return len(buf)

    def _decode(self, buf, pos: int, end: int) -> None:
        by_number = type(self)._by_number
        while pos < end:
            key, pos = _read_varint(buf, pos)
            number, wire = key >> 3, key & 7
            entry = by_number.get(number)
            if entry is None:
                pos = _skip(wire, buf, pos)
                continue
            name, f = entry
            if wire == _LEN and f.kind not in _NUMERIC:
                n, pos = _read_varint(buf, pos)
                chunk = buf[pos:pos + n]
                pos += n
                if f.kind == "msg":
                    if f.repeated:
                        m = getattr(self, name).add()
                    else:
                        m = getattr(self, name)
                    m._decode(chunk, 0, len(chunk))
                    m._touch()
                    continue
                v = bytes(chunk)
                v = v.decode("utf-8") if f.kind == "string" else v
                if f.repeated:
                    getattr(self, name).append(v)
                else:
                    setattr(self, name, v)
            elif wire == _LEN:          # packed numbers
                n, pos = _read_varint(buf, pos)
                stop, vals = pos + n, []
                while pos < stop:
                    v, pos = _decode_scalar(f.kind, _wire(f.kind), buf, pos)
                    vals.append(v)
                getattr(self, name).extend(vals)
            else:
                v, pos = _decode_scalar(f.kind, wire, buf, pos)
                if f.repeated:
                    getattr(self, name).append(v)
                else:
                    setattr(self, name, v)
        if self._values:
            self._touch()

    def __repr__(self):
        return f"{type(self).__name__}({self._values!r})"


_CLASSES: dict = {}


def _message(name: str, fields: dict, consts: dict = None, nested=()):
    cls = type(name, (Message,), dict(consts or {}))
    cls._fields = fields
    cls._by_number = {f.number: (n, f) for n, f in fields.items()}
    cls._ordered = sorted(fields.items(), key=lambda kv: kv[1].number)
    _CLASSES[name] = cls
    for sub in nested:
        setattr(cls, sub.__name__.split(".")[-1], sub)
    return cls


# The messages of diffsvc_tpu/onnx/onnx.proto, field by field.

_ATTRIBUTE_TYPES = dict(UNDEFINED=0, FLOAT=1, INT=2, STRING=3, TENSOR=4,
                        GRAPH=5, FLOATS=6, INTS=7, STRINGS=8, TENSORS=9,
                        GRAPHS=10)
_DATA_TYPES = dict(UNDEFINED=0, FLOAT=1, UINT8=2, INT8=3, UINT16=4, INT16=5,
                   INT32=6, INT64=7, STRING=8, BOOL=9, FLOAT16=10, DOUBLE=11,
                   UINT32=12, UINT64=13, COMPLEX64=14, COMPLEX128=15,
                   BFLOAT16=16)

AttributeProto = _message("AttributeProto", {
    "name": Field(1, "string"),
    "f": Field(2, "float"),
    "i": Field(3, "int64"),
    "s": Field(4, "bytes"),
    "t": Field(5, "msg", msg="TensorProto"),
    "g": Field(6, "msg", msg="GraphProto"),
    "floats": Field(7, "float", True),
    "ints": Field(8, "int64", True),
    "strings": Field(9, "bytes", True),
    "tensors": Field(10, "msg", True, "TensorProto"),
    "graphs": Field(11, "msg", True, "GraphProto"),
    "doc_string": Field(13, "string"),
    "type": Field(20, "enum"),
    "ref_attr_name": Field(21, "string"),
}, _ATTRIBUTE_TYPES)

ValueInfoProto = _message("ValueInfoProto", {
    "name": Field(1, "string"),
    "type": Field(2, "msg", msg="TypeProto"),
    "doc_string": Field(3, "string"),
})

NodeProto = _message("NodeProto", {
    "input": Field(1, "string", True),
    "output": Field(2, "string", True),
    "name": Field(3, "string"),
    "op_type": Field(4, "string"),
    "attribute": Field(5, "msg", True, "AttributeProto"),
    "doc_string": Field(6, "string"),
    "domain": Field(7, "string"),
})

StringStringEntryProto = _message("StringStringEntryProto", {
    "key": Field(1, "string"),
    "value": Field(2, "string"),
})

ModelProto = _message("ModelProto", {
    "ir_version": Field(1, "int64"),
    "producer_name": Field(2, "string"),
    "producer_version": Field(3, "string"),
    "domain": Field(4, "string"),
    "model_version": Field(5, "int64"),
    "doc_string": Field(6, "string"),
    "graph": Field(7, "msg", msg="GraphProto"),
    "opset_import": Field(8, "msg", True, "OperatorSetIdProto"),
    "metadata_props": Field(14, "msg", True, "StringStringEntryProto"),
})

GraphProto = _message("GraphProto", {
    "node": Field(1, "msg", True, "NodeProto"),
    "name": Field(2, "string"),
    "initializer": Field(5, "msg", True, "TensorProto"),
    "doc_string": Field(10, "string"),
    "input": Field(11, "msg", True, "ValueInfoProto"),
    "output": Field(12, "msg", True, "ValueInfoProto"),
    "value_info": Field(13, "msg", True, "ValueInfoProto"),
})

TensorProto = _message("TensorProto", {
    "dims": Field(1, "int64", True),
    "data_type": Field(2, "int32"),
    "float_data": Field(4, "float", True),
    "int32_data": Field(5, "int32", True),
    "string_data": Field(6, "bytes", True),
    "int64_data": Field(7, "int64", True),
    "name": Field(8, "string"),
    "raw_data": Field(9, "bytes"),
    "double_data": Field(10, "double", True),
    "uint64_data": Field(11, "uint64", True),
    "doc_string": Field(12, "string"),
}, _DATA_TYPES)

_Dimension = _message("TensorShapeProto.Dimension", {
    "dim_value": Field(1, "int64", oneof="value"),
    "dim_param": Field(2, "string", oneof="value"),
    "denotation": Field(3, "string"),
})
TensorShapeProto = _message("TensorShapeProto", {
    "dim": Field(1, "msg", True, "TensorShapeProto.Dimension"),
}, nested=(_Dimension,))

_TensorType = _message("TypeProto.Tensor", {
    "elem_type": Field(1, "int32"),
    "shape": Field(2, "msg", msg="TensorShapeProto"),
})
TypeProto = _message("TypeProto", {
    "tensor_type": Field(1, "msg", msg="TypeProto.Tensor", oneof="value"),
}, nested=(_TensorType,))

OperatorSetIdProto = _message("OperatorSetIdProto", {
    "domain": Field(1, "string"),
    "version": Field(2, "int64"),
})
