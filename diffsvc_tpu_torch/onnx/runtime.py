"""Numpy evaluator for the ONNX op subset the exporter emits.

A copy of ``diffsvc_tpu/onnx/runtime.py`` (the same 61 ops, ``op_Add`` to
``op_CumSum``, with ONNX opset-16 semantics) reading models through
:mod:`.wire`'s decoder instead of protobuf; ``tests/test_torch_onnx.py``
holds it against the original, output for output.  It validates exported
``.onnx`` artifacts without onnxruntime and drives the exported chain
(:mod:`.chain`); it is a reference interpreter, not a fast one.  The op
set is the converter's target: :mod:`.convert` emits nothing this runtime
cannot run.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import wire as P
from .builder import array_from_tensor, np_dtype


def _attr_value(a: "P.AttributeProto"):
    T = P.AttributeProto
    if a.type == T.FLOAT:
        return a.f
    if a.type == T.INT:
        return a.i
    if a.type == T.STRING:
        return a.s.decode()
    if a.type == T.FLOATS:
        return list(a.floats)
    if a.type == T.INTS:
        return list(a.ints)
    if a.type == T.TENSOR:
        return array_from_tensor(a.t)
    raise NotImplementedError(f"attribute type {a.type}")


def _conv_out_1d(x, w, b, stride, pad_begin, pad_end, dilation, groups):
    # x [N, Cin, L], w [Cout, Cin/g, K] -> [N, Cout, Lout]
    n, cin, length = x.shape
    cout, cin_g, k = w.shape
    xp = np.pad(x, ((0, 0), (0, 0), (pad_begin, pad_end)))
    keff = (k - 1) * dilation + 1
    lout = (xp.shape[2] - keff) // stride + 1
    out = np.zeros((n, cout, lout), dtype=np.promote_types(x.dtype, w.dtype))
    og = cout // groups
    for g in range(groups):
        xg = xp[:, g * cin_g:(g + 1) * cin_g]  # [N, cin_g, Lp]
        wg = w[g * og:(g + 1) * og]            # [og, cin_g, K]
        # im2col: [N, cin_g*K, Lout]
        cols = np.stack([xg[:, :, i * dilation:i * dilation + lout * stride:stride]
                         for i in range(k)], axis=2)  # [N, cin_g, K, Lout]
        cols = cols.reshape(n, cin_g * k, lout)
        out[:, g * og:(g + 1) * og] = np.einsum(
            "ok,nkl->nol", wg.reshape(og, cin_g * k), cols)
    if b is not None:
        out += b[None, :, None]
    return out


def _conv(x, w, b, strides, pads, dilations, groups):
    spatial = x.ndim - 2
    if spatial == 1:
        return _conv_out_1d(x, w, b, strides[0], pads[0], pads[1],
                            dilations[0], groups)
    if spatial == 2:
        # treat H as batch-of-1d only when kernel H == input H is false;
        # generic NCHW conv via im2col
        n, cin, H, W = x.shape
        cout, cin_g, kh, kw = w.shape
        ph0, pw0, ph1, pw1 = pads
        xp = np.pad(x, ((0, 0), (0, 0), (ph0, ph1), (pw0, pw1)))
        dh, dw = dilations
        sh, sw = strides
        kheff, kweff = (kh - 1) * dh + 1, (kw - 1) * dw + 1
        ho = (xp.shape[2] - kheff) // sh + 1
        wo = (xp.shape[3] - kweff) // sw + 1
        og = cout // groups
        out = np.zeros((n, cout, ho, wo), dtype=np.promote_types(x.dtype, w.dtype))
        for g in range(groups):
            xg = xp[:, g * cin_g:(g + 1) * cin_g]
            wg = w[g * og:(g + 1) * og].reshape(og, cin_g * kh * kw)
            cols = np.empty((n, cin_g, kh, kw, ho, wo), dtype=x.dtype)
            for i in range(kh):
                for j in range(kw):
                    cols[:, :, i, j] = xg[:, :,
                                          i * dh:i * dh + ho * sh:sh,
                                          j * dw:j * dw + wo * sw:sw]
            cols = cols.reshape(n, cin_g * kh * kw, ho * wo)
            out[:, g * og:(g + 1) * og] = np.einsum(
                "ok,nkl->nol", wg, cols).reshape(n, og, ho, wo)
        if b is not None:
            out += b[None, :, None, None]
        return out
    raise NotImplementedError(f"Conv with {spatial} spatial dims")


def _conv_transpose_1d(x, w, b, stride, pad_begin, pad_end, dilation,
                       groups, output_padding):
    # x [N, Cin, L], w [Cin, Cout/g, K] -> [N, Cout, Lout]
    n, cin, length = x.shape
    cin_w, cout_g, k = w.shape
    cout = cout_g * groups
    keff = (k - 1) * dilation + 1
    full = (length - 1) * stride + keff + output_padding
    out = np.zeros((n, cout, full), dtype=np.promote_types(x.dtype, w.dtype))
    cg = cin // groups
    for g in range(groups):
        xg = x[:, g * cg:(g + 1) * cg]                     # [N, cg, L]
        wg = w[g * cg:(g + 1) * cg]                        # [cg, cout_g, K]
        contrib = np.einsum("ncl,cok->nolk", xg, wg)       # [N, cout_g, L, K]
        for i in range(k):
            pos = i * dilation
            out[:, g * cout_g:(g + 1) * cout_g,
                pos:pos + length * stride:stride] += contrib[:, :, :, i]
    out = out[:, :, pad_begin:full - pad_end]
    if b is not None:
        out += b[None, :, None]
    return out


class OnnxRunner:
    """Parse a ModelProto and evaluate it on numpy inputs."""

    def __init__(self, model_bytes: bytes):
        m = P.ModelProto()
        m.ParseFromString(model_bytes)
        self.model = m
        self.graph = m.graph
        self.initializers: Dict[str, np.ndarray] = {
            t.name: array_from_tensor(t) for t in self.graph.initializer}
        self.input_names = [v.name for v in self.graph.input
                            if v.name not in self.initializers]
        self.output_names = [v.name for v in self.graph.output]

    def __call__(self, *args, **kwargs) -> List[np.ndarray]:
        env: Dict[str, np.ndarray] = dict(self.initializers)
        names = list(self.input_names)
        for i, a in enumerate(args):
            env[names[i]] = np.asarray(a)
        for k, v in kwargs.items():
            if k not in names:
                raise KeyError(f"unknown input {k}; expected {names}")
            env[k] = np.asarray(v)
        for node in self.graph.node:
            attrs = {a.name: _attr_value(a) for a in node.attribute}
            ins = [env[n] if n else None for n in node.input]
            outs = self._eval(node.op_type, ins, attrs, node)
            for name, val in zip(node.output, outs):
                env[name] = val
        return [env[n] for n in self.output_names]

    # --- op dispatch ----------------------------------------------------

    def _eval(self, op: str, ins, attrs, node) -> List[np.ndarray]:
        fn = getattr(self, f"op_{op}", None)
        if fn is None:
            raise NotImplementedError(f"ONNX op {op} not implemented")
        out = fn(ins, attrs)
        return out if isinstance(out, list) else [out]

    # elementwise ---------------------------------------------------------
    def op_Add(self, ins, attrs):
        return ins[0] + ins[1]

    def op_Sub(self, ins, attrs):
        return ins[0] - ins[1]

    def op_Mul(self, ins, attrs):
        return ins[0] * ins[1]

    def op_Div(self, ins, attrs):
        a, b = ins
        if np.issubdtype(a.dtype, np.integer) and np.issubdtype(b.dtype, np.integer):
            # ONNX integer Div truncates toward zero (like lax.div / C),
            # NOT numpy's floor division — they differ on negative operands
            q = np.floor_divide(a, b)
            r = a - q * b
            return (q + ((r != 0) & ((a < 0) != (b < 0)))).astype(a.dtype)
        return a / b

    def op_Mod(self, ins, attrs):
        # fmod=1: C fmod (sign of dividend, what lax.rem lowers to);
        # fmod=0: floored modulo (sign of divisor)
        if int(attrs.get("fmod", 0)):
            return np.fmod(ins[0], ins[1])
        return np.mod(ins[0], ins[1])

    def op_Neg(self, ins, attrs):
        return -ins[0]

    def op_Abs(self, ins, attrs):
        return np.abs(ins[0])

    def op_Pow(self, ins, attrs):
        return np.power(ins[0], ins[1]).astype(ins[0].dtype)

    def op_Sqrt(self, ins, attrs):
        return np.sqrt(ins[0])

    def op_Exp(self, ins, attrs):
        return np.exp(ins[0])

    def op_Log(self, ins, attrs):
        return np.log(ins[0])

    def op_Sigmoid(self, ins, attrs):
        x = ins[0]
        return np.where(x >= 0, 1.0 / (1.0 + np.exp(-np.abs(x))),
                        np.exp(-np.abs(x)) / (1.0 + np.exp(-np.abs(x)))).astype(x.dtype)

    def op_Tanh(self, ins, attrs):
        return np.tanh(ins[0])

    def op_Sin(self, ins, attrs):
        return np.sin(ins[0])

    def op_Cos(self, ins, attrs):
        return np.cos(ins[0])

    def op_Erf(self, ins, attrs):
        from scipy.special import erf
        return erf(ins[0]).astype(ins[0].dtype)

    def op_Relu(self, ins, attrs):
        return np.maximum(ins[0], 0)

    def op_LeakyRelu(self, ins, attrs):
        alpha = attrs.get("alpha", 0.01)
        x = ins[0]
        return np.where(x >= 0, x, alpha * x).astype(x.dtype)

    def op_Softplus(self, ins, attrs):
        x = ins[0]
        return (np.logaddexp(0.0, x)).astype(x.dtype)

    def op_Max(self, ins, attrs):
        out = ins[0]
        for a in ins[1:]:
            out = np.maximum(out, a)
        return out

    def op_Min(self, ins, attrs):
        out = ins[0]
        for a in ins[1:]:
            out = np.minimum(out, a)
        return out

    def op_Clip(self, ins, attrs):
        x = ins[0]
        lo = ins[1] if len(ins) > 1 and ins[1] is not None else attrs.get("min")
        hi = ins[2] if len(ins) > 2 and ins[2] is not None else attrs.get("max")
        return np.clip(x, lo, hi)

    def op_Round(self, ins, attrs):
        return np.round(ins[0])  # half-to-even, matches ONNX

    def op_Floor(self, ins, attrs):
        return np.floor(ins[0])

    def op_Ceil(self, ins, attrs):
        return np.ceil(ins[0])

    def op_Sign(self, ins, attrs):
        return np.sign(ins[0])

    def op_Where(self, ins, attrs):
        return np.where(ins[0], ins[1], ins[2])

    def op_Equal(self, ins, attrs):
        return ins[0] == ins[1]

    def op_Greater(self, ins, attrs):
        return ins[0] > ins[1]

    def op_Less(self, ins, attrs):
        return ins[0] < ins[1]

    def op_GreaterOrEqual(self, ins, attrs):
        return ins[0] >= ins[1]

    def op_LessOrEqual(self, ins, attrs):
        return ins[0] <= ins[1]

    def op_Not(self, ins, attrs):
        return ~ins[0]

    def op_And(self, ins, attrs):
        return ins[0] & ins[1]

    def op_Or(self, ins, attrs):
        return ins[0] | ins[1]

    def op_Cast(self, ins, attrs):
        return ins[0].astype(np_dtype(attrs["to"]))

    def op_Identity(self, ins, attrs):
        return ins[0]

    def op_Constant(self, ins, attrs):
        if "value" in attrs:
            return attrs["value"]
        raise NotImplementedError("Constant without tensor value")

    # shape ops -----------------------------------------------------------
    def op_Reshape(self, ins, attrs):
        data, shape = ins
        shape = [int(s) for s in shape]
        # ONNX: 0 = copy input dim, -1 = infer
        out_shape = [data.shape[i] if s == 0 else s for i, s in enumerate(shape)]
        return data.reshape(out_shape)

    def op_Transpose(self, ins, attrs):
        perm = attrs.get("perm")
        return np.transpose(ins[0], perm)

    def op_Concat(self, ins, attrs):
        return np.concatenate(ins, axis=attrs["axis"])

    def op_Slice(self, ins, attrs):
        data = ins[0]
        if len(ins) > 1:
            starts = ins[1].tolist()
            ends = ins[2].tolist()
            axes = ins[3].tolist() if len(ins) > 3 and ins[3] is not None else list(range(len(starts)))
            steps = ins[4].tolist() if len(ins) > 4 and ins[4] is not None else [1] * len(starts)
        else:  # opset<10 attribute form (torch fixture)
            starts, ends = attrs["starts"], attrs["ends"]
            axes = attrs.get("axes", list(range(len(starts))))
            steps = [1] * len(starts)
        sl = [slice(None)] * data.ndim
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            ax = int(ax) % data.ndim
            sl[ax] = slice(int(st), int(en), int(sp))
        return data[tuple(sl)]

    def op_Split(self, ins, attrs):
        data = ins[0]
        axis = attrs.get("axis", 0)
        if len(ins) > 1 and ins[1] is not None:
            sizes = ins[1].tolist()
        elif "split" in attrs:
            sizes = attrs["split"]
        else:
            n = attrs["num_outputs"]
            sizes = [data.shape[axis] // n] * n
        out, pos = [], 0
        for s in sizes:
            sl = [slice(None)] * data.ndim
            sl[axis] = slice(pos, pos + int(s))
            out.append(data[tuple(sl)])
            pos += int(s)
        return out

    def op_Squeeze(self, ins, attrs):
        data = ins[0]
        axes = (ins[1].tolist() if len(ins) > 1 and ins[1] is not None
                else attrs.get("axes"))
        if axes is None:
            return np.squeeze(data)
        return np.squeeze(data, axis=tuple(int(a) % data.ndim for a in axes))

    def op_Unsqueeze(self, ins, attrs):
        data = ins[0]
        axes = (ins[1].tolist() if len(ins) > 1 and ins[1] is not None
                else attrs["axes"])
        out_ndim = data.ndim + len(axes)
        axes = sorted(int(a) % out_ndim for a in axes)
        for a in axes:
            data = np.expand_dims(data, a)
        return data

    def op_Expand(self, ins, attrs):
        data, shape = ins
        shape = [int(s) for s in shape]
        return np.broadcast_to(data, np.broadcast_shapes(data.shape, tuple(shape))).copy()

    def op_Shape(self, ins, attrs):
        shp = np.asarray(ins[0].shape, np.int64)
        start = attrs.get("start", 0)
        end = attrs.get("end", len(shp))
        return shp[start:end]

    def op_Range(self, ins, attrs):
        start, limit, delta = (x.item() for x in ins)
        return np.arange(start, limit, delta,
                         dtype=ins[0].dtype)

    def op_Gather(self, ins, attrs):
        data, idx = ins
        return np.take(data, idx.astype(np.int64), axis=attrs.get("axis", 0))

    def op_GatherElements(self, ins, attrs):
        data, idx = ins
        return np.take_along_axis(data, idx.astype(np.int64),
                                  axis=attrs.get("axis", 0))

    def op_ScatterND(self, ins, attrs):
        data, indices, updates = ins
        out = data.copy()
        idx = indices.reshape(-1, indices.shape[-1])
        upd = updates.reshape(idx.shape[0], *updates.shape[indices.ndim - 1:])
        for i in range(idx.shape[0]):
            out[tuple(idx[i])] = upd[i]
        return out

    def op_Pad(self, ins, attrs):
        data = ins[0]
        pads = (ins[1].tolist() if len(ins) > 1 and ins[1] is not None
                else attrs["pads"])
        cval = 0.0
        if len(ins) > 2 and ins[2] is not None:
            cval = ins[2].item()
        mode = attrs.get("mode", "constant")
        n = data.ndim
        widths = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
        if mode == "constant":
            return np.pad(data, widths, constant_values=cval)
        return np.pad(data, widths, mode={"reflect": "reflect", "edge": "edge"}[mode])

    # reductions ----------------------------------------------------------
    def _reduce(self, ins, attrs, fn):
        data = ins[0]
        axes = (ins[1].tolist() if len(ins) > 1 and ins[1] is not None
                else attrs.get("axes"))
        keep = bool(attrs.get("keepdims", 1))
        ax = None if axes is None else tuple(int(a) % data.ndim for a in axes)
        return fn(data, axis=ax, keepdims=keep)

    def op_ReduceSum(self, ins, attrs):
        return self._reduce(ins, attrs, np.sum)

    def op_ReduceMean(self, ins, attrs):
        return self._reduce(ins, attrs, np.mean)

    def op_ReduceMax(self, ins, attrs):
        return self._reduce(ins, attrs, np.max)

    def op_ReduceMin(self, ins, attrs):
        return self._reduce(ins, attrs, np.min)

    # contractions --------------------------------------------------------
    def op_MatMul(self, ins, attrs):
        return np.matmul(ins[0], ins[1])

    def op_Gemm(self, ins, attrs):
        a, b = ins[0], ins[1]
        if attrs.get("transA"):
            a = a.T
        if attrs.get("transB"):
            b = b.T
        out = attrs.get("alpha", 1.0) * (a @ b)
        if len(ins) > 2 and ins[2] is not None:
            out = out + attrs.get("beta", 1.0) * ins[2]
        return out.astype(ins[0].dtype)

    def op_Conv(self, ins, attrs):
        x, w = ins[0], ins[1]
        b = ins[2] if len(ins) > 2 else None
        spatial = x.ndim - 2
        strides = attrs.get("strides", [1] * spatial)
        dil = attrs.get("dilations", [1] * spatial)
        pads = attrs.get("pads", [0] * (2 * spatial))
        groups = attrs.get("group", 1)
        return _conv(x, w, b, strides, pads, dil, groups)

    def op_ConvTranspose(self, ins, attrs):
        x, w = ins[0], ins[1]
        b = ins[2] if len(ins) > 2 else None
        if x.ndim != 3:
            raise NotImplementedError("ConvTranspose only 1-D here")
        strides = attrs.get("strides", [1])
        dil = attrs.get("dilations", [1])
        pads = attrs.get("pads", [0, 0])
        opad = attrs.get("output_padding", [0])
        groups = attrs.get("group", 1)
        return _conv_transpose_1d(x, w, b, strides[0], pads[0], pads[1],
                                  dil[0], groups, opad[0])

    def op_CumSum(self, ins, attrs):
        data, axis = ins
        ax = int(axis)
        if attrs.get("reverse"):
            data = np.flip(data, axis=ax)
        out = np.cumsum(data, axis=ax)
        if attrs.get("exclusive"):
            out = np.roll(out, 1, axis=ax)
            sl = [slice(None)] * data.ndim
            sl[ax] = 0
            out[tuple(sl)] = 0
        if attrs.get("reverse"):
            out = np.flip(out, axis=ax)
        return out.astype(data.dtype)
