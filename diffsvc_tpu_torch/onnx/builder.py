"""Low-level ONNX graph assembly on top of the wire-format messages.

A copy of ``diffsvc_tpu/onnx/builder.py`` (same functions, same bytes out)
on :mod:`.wire` instead of protobuf's generated bindings;
``tests/test_torch_onnx.py`` holds it against the original.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from . import wire as P

# numpy dtype -> TensorProto.DataType
_NP_TO_ONNX = {
    np.dtype(np.float32): P.FLOAT,
    np.dtype(np.float64): P.DOUBLE,
    np.dtype(np.float16): P.FLOAT16,
    np.dtype(np.int64): P.INT64,
    np.dtype(np.int32): P.INT32,
    np.dtype(np.int16): P.INT16,
    np.dtype(np.int8): P.INT8,
    np.dtype(np.uint8): P.UINT8,
    np.dtype(np.uint32): P.UINT32,
    np.dtype(np.uint64): P.UINT64,
    np.dtype(np.bool_): P.BOOL,
}
_ONNX_TO_NP = {v: k for k, v in _NP_TO_ONNX.items()}


def onnx_dtype(np_dtype) -> int:
    d = np.dtype(np_dtype)
    if d not in _NP_TO_ONNX:
        raise NotImplementedError(f"no ONNX mapping for dtype {d}")
    return _NP_TO_ONNX[d]


def np_dtype(onnx_type: int) -> np.dtype:
    if onnx_type == P.BFLOAT16:
        # numpy has no bfloat16; validation runtime upcasts.
        return np.dtype(np.float32)
    return _ONNX_TO_NP[onnx_type]


def tensor_from_array(arr: np.ndarray, name: str) -> "P.TensorProto":
    arr = np.asarray(arr)
    t = P.TensorProto()
    t.name = name
    t.dims.extend(arr.shape)
    t.data_type = onnx_dtype(arr.dtype)
    t.raw_data = np.ascontiguousarray(arr).tobytes()
    return t


def array_from_tensor(t: "P.TensorProto") -> np.ndarray:
    shape = tuple(t.dims)
    if t.raw_data:
        if t.data_type == P.BFLOAT16:
            u16 = np.frombuffer(t.raw_data, dtype=np.uint16)
            arr = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(t.raw_data, dtype=np_dtype(t.data_type))
        return arr.reshape(shape).copy()
    # fall back to the typed repeated fields (torch sometimes uses them)
    if t.data_type == P.FLOAT:
        return np.asarray(t.float_data, np.float32).reshape(shape)
    if t.data_type == P.INT64:
        return np.asarray(t.int64_data, np.int64).reshape(shape)
    if t.data_type in (P.INT32, P.INT16, P.INT8, P.UINT8, P.BOOL):
        return np.asarray(t.int32_data, np.int32).astype(np_dtype(t.data_type)).reshape(shape)
    if t.data_type == P.DOUBLE:
        return np.asarray(t.double_data, np.float64).reshape(shape)
    raise NotImplementedError(f"tensor field decode for data_type={t.data_type}")


DimSpec = Union[int, str]  # int = static, str = dim_param (dynamic)


def value_info(name: str, elem_type: int, dims: Sequence[DimSpec]) -> "P.ValueInfoProto":
    vi = P.ValueInfoProto()
    vi.name = name
    vi.type.tensor_type.elem_type = elem_type
    for d in dims:
        dim = vi.type.tensor_type.shape.dim.add()
        if isinstance(d, str):
            dim.dim_param = d
        else:
            dim.dim_value = int(d)
    return vi


class GraphBuilder:
    """Accumulates nodes/initializers and emits a ModelProto."""

    def __init__(self, name: str, opset: int = 16,
                 producer: str = "diffsvc_tpu"):
        self.graph = P.GraphProto()
        self.graph.name = name
        self.opset = opset
        self.producer = producer
        self._counter = 0
        self._init_names: Dict[tuple, str] = {}

    def fresh(self, hint: str = "t") -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def add_initializer(self, arr: np.ndarray, name: Optional[str] = None,
                        hint: str = "const") -> str:
        """Add a constant tensor; dedupes identical arrays by content."""
        arr = np.asarray(arr)
        if name is None:
            # key on the content itself (not hash(key)) — a 64-bit hash
            # collision would silently alias two different weight tensors
            key = (arr.dtype.str, arr.shape, arr.tobytes())
            if key in self._init_names:
                return self._init_names[key]
            name = self.fresh(hint)
            self._init_names[key] = name
        self.graph.initializer.append(tensor_from_array(arr, name))
        return name

    def add_node(self, op_type: str, inputs: Sequence[str],
                 n_outputs: int = 1, outputs: Optional[Sequence[str]] = None,
                 **attrs) -> List[str]:
        node = self.graph.node.add()
        node.op_type = op_type
        node.name = self.fresh(op_type)
        node.input.extend(inputs)
        if outputs is None:
            outputs = [self.fresh(op_type.lower()) for _ in range(n_outputs)]
        node.output.extend(outputs)
        for k, v in attrs.items():
            a = node.attribute.add()
            a.name = k
            if isinstance(v, (float, np.floating)):
                a.type = P.AttributeProto.FLOAT
                a.f = float(v)
            elif isinstance(v, (bool, int, np.integer)):
                a.type = P.AttributeProto.INT
                a.i = int(v)
            elif isinstance(v, str):
                a.type = P.AttributeProto.STRING
                a.s = v.encode()
            elif isinstance(v, (list, tuple, np.ndarray)):
                v = list(v)
                if v and isinstance(v[0], (float, np.floating)):
                    a.type = P.AttributeProto.FLOATS
                    a.floats.extend(float(x) for x in v)
                else:
                    a.type = P.AttributeProto.INTS
                    a.ints.extend(int(x) for x in v)
            else:
                raise NotImplementedError(f"attribute {k}={v!r}")
        return list(outputs)

    def add_input(self, name: str, elem_type: int, dims: Sequence[DimSpec]):
        self.graph.input.append(value_info(name, elem_type, dims))

    def add_output(self, name: str, elem_type: int, dims: Sequence[DimSpec]):
        self.graph.output.append(value_info(name, elem_type, dims))

    def model(self, doc: str = "") -> "P.ModelProto":
        m = P.ModelProto()
        m.ir_version = 8
        m.producer_name = self.producer
        m.producer_version = "0.1"
        m.doc_string = doc
        op = m.opset_import.add()
        op.domain = ""
        op.version = self.opset
        m.graph.CopyFrom(self.graph)
        return m

    def model_bytes(self, doc: str = "") -> bytes:
        return self.model(doc).SerializeToString()
