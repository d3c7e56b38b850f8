"""torch.export -> ONNX graph converter.

Counterpart of ``diffsvc_tpu/onnx/convert.py:1023`` ``export_onnx``, with
torch's tools in the places of JAX's: ``torch.export.export`` (with
``torch.export.Dim`` on the dynamic axes) plays the part of
``jax.make_jaxpr``, and the ATen graph it gives is walked node by node into
ONNX nodes (opset 16) written by :mod:`.builder` on :mod:`.wire`.  Neither
``onnx``, ``onnxscript`` nor protobuf is needed.

Design:

- **Constants**: lifted parameters, buffers and tensor constants are
  constants; so is every node whose inputs are all constants, which is
  evaluated with torch at export time (the JAX converter's ``_fold``).
  Only the data-dependent spine becomes ONNX nodes, and a constant becomes
  an initializer where such a node consumes it (named after its
  state-dict entry when it is one), so a weight reshaped or stacked by the
  module appears once, in the layout its consumer reads.
- **Dynamic axes**: each axis named in ``dynamic_axes`` is traced as
  ``Dim.AUTO``; torch.export unifies axes that the program ties together
  (the denoiser's noise and condition lengths).  An axis that the program
  pins to its trace length is an error, not a fixed-length graph.  Symbolic
  sizes (``sym_size`` and arithmetic on them) become int64 ``Shape`` /
  ``Concat`` / ``Add`` ... chains, so the graph runs at other lengths.
  Graph inputs declare ``{name}_dyn_{axis}`` as the JAX exporter does;
  outputs name a dynamic dim after the first input axis of the same size
  (or spell the expression out, as ``32*f0_dyn_1``).
- **The program is not decomposed** to core ATen (that re-trace doubles
  the export's time and turns each ``matmul`` into views and ``mm``):
  ``linear``, ``matmul``, two-operand ``einsum``, ``conv1d``,
  ``conv_transpose1d``, ``layer_norm``, ``pad`` and ``fft_irfft`` are
  mapped as they come.
- **Op set**: the ops of :mod:`.runtime`, which can run everything emitted;
  an ATen op with no mapping raises ``NotImplementedError`` naming it.
  Arithmetic follows torch's type promotion with explicit ``Cast`` nodes;
  ``remainder`` is ``Mod`` (fmod=1) with torch's sign fix-up; mish is
  x·tanh(softplus(x)); layer norm and gelu are written out in elementwise
  ops; ``complex`` + ``fft_irfft`` become the real inverse DFT as two
  MatMuls with the JAX package's synthesis matrices
  (``diffsvc_tpu/ops/istft.py:_irdft_mats``).
- :func:`trace` and :meth:`Traced.onnx` split the export: one trace can be
  converted again with some parameters replaced (``state``), at the cost of
  a conversion and no new trace.
"""

from __future__ import annotations

import math
import operator
import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .builder import GraphBuilder, onnx_dtype

_INT64_MAX = 2 ** 63 - 1
_SKIP = {"aten._assert_tensor_metadata.default", "aten._assert_scalar.default",
         "aten.sym_constrain_range_for_size.default"}
_IDENTITY = {"clone", "alias", "lift_fresh_copy", "detach", "contiguous"}
_UNARY = {"neg": "Neg", "abs": "Abs", "exp": "Exp", "log": "Log",
          "sqrt": "Sqrt", "sin": "Sin", "cos": "Cos", "tanh": "Tanh",
          "sigmoid": "Sigmoid", "relu": "Relu", "erf": "Erf",
          "floor": "Floor", "ceil": "Ceil", "sign": "Sign",
          "logical_not": "Not"}
_BINARY = {"add": "Add", "sub": "Sub", "mul": "Mul", "div": "Div",
           "maximum": "Max", "minimum": "Min", "pow": "Pow",
           "logical_and": "And", "logical_or": "Or"}
_COMPARE = {"eq": "Equal", "lt": "Less", "le": "LessOrEqual",
            "gt": "Greater", "ge": "GreaterOrEqual"}
_SYM_OPS = {operator.add: "Add", operator.sub: "Sub", operator.mul: "Mul",
            operator.floordiv: "Div"}


class Sym:
    """A tensor computed by the graph: its ONNX name and torch.export's
    (fake) value, which carries dtype and shape."""

    __slots__ = ("name", "val")

    def __init__(self, name: str, val):
        self.name = name
        self.val = val

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    @property
    def ndim(self) -> int:
        return self.val.dim()


class SymInt:
    """A symbolic size: the ONNX name of an int64 [1] tensor."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name


class Complex:
    """re + i im, each a :class:`Sym` (``aten.complex``)."""

    __slots__ = ("re", "im")

    def __init__(self, re, im):
        self.re, self.im = re, im


def _symbolic(v) -> bool:
    if isinstance(v, (Sym, SymInt, Complex)):
        return True
    if isinstance(v, (list, tuple)):
        return any(_symbolic(x) for x in v)
    if isinstance(v, dict):
        return any(_symbolic(x) for x in v.values())
    return False


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy()


def _onnx_type(dtype: torch.dtype) -> int:
    return onnx_dtype(torch.empty((), dtype=dtype).numpy().dtype)


def irdft_mats(n_fft: int):
    """[n_bins, n_fft] cos/sin synthesis matrices of the real inverse DFT
    normalized by N (``diffsvc_tpu/ops/istft.py:_irdft_mats``)."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    w = np.full((n_bins, 1), 2.0)
    w[0] = w[-1] = 1.0
    cos_m = (w * np.cos(ang) / n_fft).astype(np.float32)
    sin_m = (w * np.sin(ang) / n_fft).astype(np.float32)
    return cos_m, sin_m


class Converter:
    """Walks one exported program's graph into a :class:`GraphBuilder`."""

    def __init__(self, b: GraphBuilder, names: Dict[int, str]):
        self.b = b
        self.param_names = names        # id(tensor) -> state-dict name
        self.init_of: Dict[int, tuple] = {}

    # --- values -> ONNX names ---------------------------------------------

    def const(self, arr: np.ndarray) -> str:
        return self.b.add_initializer(np.asarray(arr))

    def tensor(self, v, dtype: Optional[torch.dtype] = None) -> str:
        """ONNX name of ``v`` (a Sym, a symbolic size, a constant tensor or
        a Python number), cast to ``dtype`` when one is given."""
        if isinstance(v, (Sym, SymInt)):
            have = v.dtype if isinstance(v, Sym) else torch.int64
            if dtype is None or have == dtype:
                return v.name
            return self.node("Cast", [v.name], to=_onnx_type(dtype))
        if isinstance(v, torch.Tensor):
            if dtype is not None and v.dtype != dtype:
                return self.const(_np(v.to(dtype)))
            key = id(v)
            if key not in self.init_of:
                name = self.param_names.get(key)
                if name is not None:
                    name = self.b.add_initializer(_np(v), name=name)
                else:
                    name = self.const(_np(v))
                self.init_of[key] = (v, name)   # v kept alive with its id
            return self.init_of[key][1]
        if isinstance(v, (bool, int, float)):
            dt = dtype or (torch.bool if isinstance(v, bool) else torch.int64
                           if isinstance(v, int) else torch.float32)
            return self.const(_np(torch.tensor(v, dtype=dt)))
        raise NotImplementedError(f"cannot make a tensor of {v!r}")

    def ints(self, xs) -> str:
        """A 1-D int64 tensor from ints and symbolic sizes."""
        parts, run = [], []
        for x in xs:
            if isinstance(x, SymInt):
                if run:
                    parts.append(self.const(np.asarray(run, np.int64)))
                    run = []
                parts.append(x.name)
            else:
                run.append(int(x))
        if run or not parts:
            parts.append(self.const(np.asarray(run, np.int64)))
        return parts[0] if len(parts) == 1 else self.node("Concat", parts,
                                                          axis=0)

    def node(self, op: str, inputs, **attrs) -> str:
        return self.b.add_node(op, list(inputs), **attrs)[0]

    def sym(self, name: str, fx_node) -> Sym:
        return Sym(name, fx_node.meta["val"])

    def reshape(self, x: str, shape) -> str:
        """Reshape to ``shape`` (ints and torch SymInts): the one symbolic
        size, if any, is inferred (-1)."""
        dims = [int(d) if not isinstance(d, torch.SymInt) else -1
                for d in shape]
        if dims.count(-1) > 1:
            raise NotImplementedError(f"reshape to {list(shape)}: more than "
                                      "one symbolic size")
        return self.node("Reshape", [x, self.ints(dims)])

    # --- the walk ---------------------------------------------------------

    def run(self, gm, env: dict):
        outputs = None
        for n in gm.graph.nodes:
            if n.op == "placeholder":
                continue
            if n.op == "output":
                outputs = [env[a.name] if isinstance(a, torch.fx.Node) else a
                           for a in n.args[0]]
                continue
            if n.op != "call_function":
                raise NotImplementedError(f"fx node {n.op} {n.target}")
            args = torch.fx.node.map_arg(n.args, lambda a: env[a.name])
            kwargs = torch.fx.node.map_arg(n.kwargs, lambda a: env[a.name])
            env[n.name] = self.call(n, args, kwargs)
        return outputs

    def call(self, n, args, kwargs):
        target = n.target
        key = str(target)
        if key in _SKIP:
            return None
        if target is operator.getitem:
            return args[0][args[1]]
        if not _symbolic(args) and not _symbolic(kwargs):
            # nothing of the graph's inputs reaches this node: fold it
            return target(*args, **kwargs)
        if target in _SYM_OPS:
            return SymInt(self.node(_SYM_OPS[target], [
                self.tensor(a) for a in args]))
        parts = key.split(".")
        if parts[0] != "aten":
            raise NotImplementedError(f"no ONNX mapping for {key}")
        base = parts[1]
        if base in _IDENTITY:
            return args[0]
        fn = getattr(self, f"op_{base}", None)
        if fn is not None:
            return fn(n, args, kwargs)
        if base in _UNARY:
            return self.sym(self.node(_UNARY[base], [self.tensor(args[0])]),
                            n)
        if base in _BINARY or base in _COMPARE or base == "ne":
            return self.binary(n, base, args, kwargs)
        raise NotImplementedError(f"no ONNX mapping for {key}")

    # --- elementwise ------------------------------------------------------

    @staticmethod
    def _meta(v):
        if isinstance(v, Sym):
            return v.val
        if isinstance(v, SymInt):
            return torch.empty((), dtype=torch.int64)
        return v

    def binary(self, n, base, args, kwargs):
        a, b = args[0], args[1]
        out = n.meta["val"]
        if base in _COMPARE or base == "ne":
            dt = torch.result_type(self._meta(a), self._meta(b))
        else:
            dt = out.dtype
        if kwargs.get("alpha", 1) != 1 or kwargs.get("rounding_mode"):
            raise NotImplementedError(f"aten.{base} with {kwargs}")
        ab = [self.tensor(a, dt), self.tensor(b, dt)]
        if base == "ne":
            return self.sym(self.node("Not", [self.node("Equal", ab)]), n)
        return self.sym(self.node(_COMPARE.get(base) or _BINARY[base], ab),
                        n)

    def op_rsub(self, n, args, kwargs):
        dt = n.meta["val"].dtype
        return self.sym(self.node("Sub", [self.tensor(args[1], dt),
                                          self.tensor(args[0], dt)]), n)

    def op_reciprocal(self, n, args, kwargs):
        dt = n.meta["val"].dtype
        return self.sym(self.node("Div", [self.tensor(1.0, dt),
                                          self.tensor(args[0], dt)]), n)

    def op_remainder(self, n, args, kwargs):
        """torch's remainder: C fmod, plus the divisor where the signs of
        the result and the divisor differ."""
        dt = n.meta["val"].dtype
        a, b = self.tensor(args[0], dt), self.tensor(args[1], dt)
        r = self.node("Mod", [a, b], fmod=1)
        zero = self.tensor(0, dt)
        fix = self.node("And", [
            self.node("Not", [self.node("Equal", [r, zero])]),
            self.node("Not", [self.node("Equal", [
                self.node("Less", [r, zero]),
                self.node("Less", [b, zero])])])])
        return self.sym(self.node("Where", [fix, self.node("Add", [r, b]),
                                            r]), n)

    def op_where(self, n, args, kwargs):
        dt = n.meta["val"].dtype
        return self.sym(self.node("Where", [
            self.tensor(args[0], torch.bool), self.tensor(args[1], dt),
            self.tensor(args[2], dt)]), n)

    def op_clamp(self, n, args, kwargs):
        lo = args[1] if len(args) > 1 else kwargs.get("min")
        hi = args[2] if len(args) > 2 else kwargs.get("max")
        dt = n.meta["val"].dtype
        name = self.tensor(args[0], dt)
        if isinstance(lo, Sym) or isinstance(hi, Sym):
            if lo is not None:
                name = self.node("Max", [name, self.tensor(lo, dt)])
            if hi is not None:
                name = self.node("Min", [name, self.tensor(hi, dt)])
            return self.sym(name, n)
        return self.sym(self.node("Clip", [
            name, "" if lo is None else self.tensor(lo, dt),
            "" if hi is None else self.tensor(hi, dt)]), n)

    def op_round(self, n, args, kwargs):
        if len(args) > 1 or kwargs.get("decimals"):
            raise NotImplementedError("round with decimals")
        return self.sym(self.node("Round", [self.tensor(args[0])]), n)

    def op_leaky_relu(self, n, args, kwargs):
        slope = args[1] if len(args) > 1 else kwargs.get("negative_slope",
                                                         0.01)
        return self.sym(self.node("LeakyRelu", [self.tensor(args[0])],
                                  alpha=float(slope)), n)

    def _softplus(self, x: str, dt, beta=1.0) -> str:
        if beta == 1:
            return self.node("Softplus", [x])
        bx = self.node("Mul", [x, self.tensor(float(beta), dt)])
        return self.node("Div", [self.node("Softplus", [bx]),
                                 self.tensor(float(beta), dt)])

    def op_softplus(self, n, args, kwargs):
        dt = n.meta["val"].dtype
        beta = args[1] if len(args) > 1 else kwargs.get("beta", 1.0)
        return self.sym(self._softplus(self.tensor(args[0], dt), dt, beta), n)

    def op_mish(self, n, args, kwargs):
        dt = n.meta["val"].dtype
        x = self.tensor(args[0], dt)
        return self.sym(self.node("Mul", [x, self.node("Tanh", [
            self._softplus(x, dt)])]), n)

    def op_gelu(self, n, args, kwargs):
        dt = n.meta["val"].dtype
        x = self.tensor(args[0], dt)
        approx = kwargs.get("approximate", args[1] if len(args) > 1
                            else "none")

        def c(v):
            return self.tensor(float(v), dt)

        if approx == "tanh":
            x3 = self.node("Mul", [self.node("Mul", [x, x]), x])
            inner = self.node("Mul", [c(math.sqrt(2.0 / math.pi)),
                                      self.node("Add", [x, self.node(
                                          "Mul", [c(0.044715), x3])])])
            gate = self.node("Add", [c(1.0), self.node("Tanh", [inner])])
        else:
            gate = self.node("Add", [c(1.0), self.node("Erf", [self.node(
                "Div", [x, c(math.sqrt(2.0))])])])
        return self.sym(self.node("Mul", [self.node("Mul", [c(0.5), x]),
                                          gate]), n)

    def op_to(self, n, args, kwargs):
        """A Cast to the node's dtype (the device is the graph's)."""
        return Sym(self.tensor(args[0], n.meta["val"].dtype), n.meta["val"])

    # --- shapes -----------------------------------------------------------

    def op_sym_size(self, n, args, kwargs):
        x, d = args
        d = d % x.ndim
        return SymInt(self.node("Shape", [x.name], start=d, end=d + 1))

    def op_view(self, n, args, kwargs):
        shape = list(args[1])
        syms = [i for i, s in enumerate(shape) if isinstance(s, SymInt)]
        if len(syms) == 1 and -1 not in shape:
            shape[syms[0]] = -1      # the one symbolic size is inferred
        return self.sym(self.node("Reshape", [self.tensor(args[0]),
                                              self.ints(shape)]), n)

    op_reshape = op_view

    def op_flatten(self, n, args, kwargs):
        return self.sym(self.reshape(self.tensor(args[0]),
                                     n.meta["val"].shape), n)

    def op_permute(self, n, args, kwargs):
        perm = [int(p) % args[0].ndim for p in args[1]]
        return self.sym(self.node("Transpose", [self.tensor(args[0])],
                                  perm=perm), n)

    def op_t(self, n, args, kwargs):
        return self.sym(self.node("Transpose", [self.tensor(args[0])],
                                  perm=[1, 0]), n)

    def op_transpose(self, n, args, kwargs):
        nd = args[0].ndim
        perm = list(range(nd))
        a, b = args[1] % nd, args[2] % nd
        perm[a], perm[b] = perm[b], perm[a]
        return self.sym(self.node("Transpose", [self.tensor(args[0])],
                                  perm=perm), n)

    def op_unsqueeze(self, n, args, kwargs):
        d = args[1] % (args[0].ndim + 1)
        return self.sym(self.node("Unsqueeze", [
            self.tensor(args[0]), self.ints([d])]), n)

    def op_expand(self, n, args, kwargs):
        shape = [1 if (isinstance(s, int) and s == -1) else s
                 for s in args[1]]
        return self.sym(self.node("Expand", [self.tensor(args[0]),
                                             self.ints(shape)]), n)

    def op_select(self, n, args, kwargs):
        x, dim, idx = args
        return self.sym(self.node("Gather", [
            self.tensor(x), self.const(np.asarray(idx, np.int64))],
            axis=dim % x.ndim), n)

    def op_slice(self, n, args, kwargs):
        x = args[0]
        dim = args[1] if len(args) > 1 else 0
        start = args[2] if len(args) > 2 and args[2] is not None else 0
        end = args[3] if len(args) > 3 and args[3] is not None \
            else _INT64_MAX
        step = args[4] if len(args) > 4 else 1
        if not isinstance(start, SymInt) and not isinstance(end, SymInt):
            if start == 0 and end >= _INT64_MAX and step == 1:
                return x
            end = min(end, _INT64_MAX)
        return self.sym(self.node("Slice", [
            self.tensor(x), self.ints([start]), self.ints([end]),
            self.ints([dim % x.ndim]), self.ints([step])]), n)

    def op_cat(self, n, args, kwargs):
        dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
        out = n.meta["val"]
        xs = [x for x in args[0] if not (isinstance(x, torch.Tensor)
                                         and x.dim() == 1 and x.numel() == 0)]
        return self.sym(self.node("Concat", [self.tensor(x, out.dtype)
                                             for x in xs],
                                  axis=dim % out.dim()), n)

    def op_pad(self, n, args, kwargs):
        mode = args[2] if len(args) > 2 else kwargs.get("mode", "constant")
        if mode != "constant":
            raise NotImplementedError(f"pad mode {mode}")
        value = args[3] if len(args) > 3 else kwargs.get("value")
        return self.op_constant_pad_nd(n, [args[0], args[1], value or 0], {})

    def op_constant_pad_nd(self, n, args, kwargs):
        x, pad = args[0], list(args[1])
        value = args[2] if len(args) > 2 else kwargs.get("value", 0)
        if any(not isinstance(p, int) or p < 0 for p in pad):
            raise NotImplementedError("pad with negative or symbolic sizes")
        nd = x.ndim
        begins, ends = [0] * nd, [0] * nd
        for i in range(len(pad) // 2):
            begins[nd - 1 - i], ends[nd - 1 - i] = pad[2 * i], pad[2 * i + 1]
        return self.sym(self.node("Pad", [
            self.tensor(x), self.ints(begins + ends),
            self.tensor(value, x.dtype)], mode="constant"), n)

    def op_index(self, n, args, kwargs):
        x, indices = args
        used = [(i, ix) for i, ix in enumerate(indices) if ix is not None]
        if len(used) != 1:
            raise NotImplementedError("index with more than one index tensor")
        axis, ix = used[0]
        return self.sym(self.node("Gather", [
            self.tensor(x), self.tensor(ix, torch.int64)], axis=axis), n)

    def op_gather(self, n, args, kwargs):
        x, dim, ix = args[0], args[1], args[2]
        return self.sym(self.node("GatherElements", [
            self.tensor(x), self.tensor(ix, torch.int64)],
            axis=dim % self._meta(x).dim()), n)

    def op_embedding(self, n, args, kwargs):
        return self.sym(self.node("Gather", [
            self.tensor(args[0]), self.tensor(args[1], torch.int64)],
            axis=0), n)

    def op_cumsum(self, n, args, kwargs):
        x, dim = args[0], args[1]
        dt = n.meta["val"].dtype
        return self.sym(self.node("CumSum", [
            self.tensor(x, dt), self.const(np.asarray(dim % x.ndim,
                                                      np.int64))]), n)

    def op_arange(self, n, args, kwargs):
        out = n.meta["val"]
        start, end, step = (list(args) + [1])[:3] if len(args) > 1 \
            else (0, args[0], 1)

        def scalar(v):
            if isinstance(v, SymInt):
                return self.node("Squeeze", [self.tensor(v, out.dtype),
                                             self.ints([0])])
            return self.const(_np(torch.tensor(v, dtype=out.dtype)))
        return self.sym(self.node("Range", [scalar(start), scalar(end),
                                            scalar(step)]), n)

    def _filled(self, n, value, like=None, shape=None):
        """A tensor of ``value`` of the node's dtype and shape: a constant
        when the shape is static, else ``Expand`` of the scalar."""
        out = n.meta["val"]
        if all(isinstance(s, int) for s in out.shape):
            return torch.full(tuple(out.shape), value, dtype=out.dtype)
        shp = (self.node("Shape", [like.name]) if like is not None
               else self.ints(shape))
        return self.sym(self.node("Expand", [self.tensor(value, out.dtype),
                                             shp]), n)

    def op_zeros(self, n, args, kwargs):
        return self._filled(n, 0, shape=args[0])

    def op_zeros_like(self, n, args, kwargs):
        return self._filled(n, 0, like=args[0])

    # --- reductions, products --------------------------------------------

    def _axes(self, x, dims):
        if dims is None:
            return list(range(x.ndim))
        dims = [dims] if isinstance(dims, int) else dims
        return [d % x.ndim for d in dims]

    def op_sum(self, n, args, kwargs):
        x = args[0]
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        dt = n.meta["val"].dtype
        return self.sym(self.node("ReduceSum", [
            self.tensor(x, dt), self.ints(self._axes(x, dims))],
            keepdims=int(keep)), n)

    def op_matmul(self, n, args, kwargs):
        return self.sym(self.node("MatMul", [self.tensor(args[0]),
                                             self.tensor(args[1])]), n)

    def op_linear(self, n, args, kwargs):
        x, w = args[0], args[1]
        b = args[2] if len(args) > 2 else kwargs.get("bias")
        wt = (self.const(_np(w.t())) if isinstance(w, torch.Tensor)
              else self.node("Transpose", [self.tensor(w)], perm=[1, 0]))
        y = self.node("MatMul", [self.tensor(x), wt])
        if b is not None:
            y = self.node("Add", [y, self.tensor(b)])
        return self.sym(y, n)

    def op_einsum(self, n, args, kwargs):
        """Two operands as one MatMul: each operand transposed to [its own
        indices, the contracted ones] (the right one [contracted, own]),
        flattened to 2-D, multiplied, unflattened and transposed to the
        output's order.  No index may appear in both operands and the
        output (a batch index); each side holds at most one symbolic
        size."""
        eq, ops = args[0].replace(" ", ""), args[1]
        ins, out = eq.split("->")
        ins = ins.split(",")
        if len(ops) != 2 or "." in eq or any(len(set(s)) != len(s)
                                            for s in ins):
            raise NotImplementedError(f"einsum {eq}")
        (sa, sb), (a, b) = ins, ops
        con = [c for c in sa if c in sb and c not in out]
        if any(c in sa and c in sb for c in out):
            raise NotImplementedError(f"einsum {eq} with a batch index")
        left = [c for c in sa if c not in con]
        right = [c for c in sb if c not in con]
        sizes = {}
        for s, v in ((sa, a), (sb, b)):
            sizes.update(zip(s, self._meta(v).shape))

        def side(v, s, order, rows):
            perm = [s.index(c) for c in order]
            k = int(np.prod([sizes[c] for c in con], dtype=np.int64))
            own = [sizes[c] for c in (left if rows else right)]
            shape = [-1 if any(isinstance(d, torch.SymInt) for d in own)
                     else int(np.prod(own, dtype=np.int64)), k]
            shape = shape if rows else shape[::-1]
            if isinstance(v, torch.Tensor):       # a weight: laid out now
                return self.const(_np(v.to(n.meta["val"].dtype)
                                      .permute(perm).reshape(shape)))
            name = self.tensor(v, n.meta["val"].dtype)
            if perm != list(range(len(s))):
                name = self.node("Transpose", [name], perm=perm)
            return self.reshape(name, shape)

        y = self.node("MatMul", [side(a, sa, left + con, True),
                                 side(b, sb, con + right, False)])
        y = self.reshape(y, [sizes[c] for c in left + right])
        perm = [(left + right).index(c) for c in out]
        if perm != list(range(len(out))):
            y = self.node("Transpose", [y], perm=perm)
        return self.sym(y, n)

    def _conv(self, n, x, w, bias, attrs, transposed=False):
        inputs = [self.tensor(x), self.tensor(w)]
        if bias is not None:
            inputs.append(self.tensor(bias))
        return self.sym(self.node("ConvTranspose" if transposed else "Conv",
                                  inputs, **attrs), n)

    def op_conv1d(self, n, args, kwargs):
        x, w, bias, stride, padding, dilation, groups = (
            list(args) + [None, [1], [0], [1], 1][len(args) - 2:])
        if isinstance(padding, str):
            raise NotImplementedError(f"conv1d padding={padding!r}")
        return self._conv(n, x, w, bias, dict(
            strides=list(stride), pads=list(padding) * 2,
            dilations=list(dilation), group=int(groups)))

    def op_conv_transpose1d(self, n, args, kwargs):
        x, w, bias, stride, padding, out_pad, groups, dilation = (
            list(args) + [None, [1], [0], [0], 1, [1]][len(args) - 2:])
        attrs = dict(strides=list(stride), pads=list(padding) * 2,
                     dilations=list(dilation), group=int(groups))
        if any(out_pad):
            attrs["output_padding"] = list(out_pad)
        return self._conv(n, x, w, bias, attrs, transposed=True)

    def op_layer_norm(self, n, args, kwargs):
        """LayerNorm written out: ReduceMean over the normalized axes."""
        x, shape = args[0], args[1]
        w, bias, eps = (list(args[2:5]) + [None, None, 1e-5][len(args) - 2:]
                        )[:3]
        dt = x.dtype
        axes = list(range(x.ndim - len(shape), x.ndim))
        mean = self.node("ReduceMean", [x.name], axes=axes, keepdims=1)
        d = self.node("Sub", [x.name, mean])
        var = self.node("ReduceMean", [self.node("Mul", [d, d])], axes=axes,
                        keepdims=1)
        y = self.node("Div", [d, self.node("Sqrt", [self.node("Add", [
            var, self.tensor(float(eps), dt)])])])
        if w is not None:
            y = self.node("Mul", [y, self.tensor(w, dt)])
        if bias is not None:
            y = self.node("Add", [y, self.tensor(bias, dt)])
        return self.sym(y, n)

    # --- the real inverse DFT ------------------------------------------------

    def op_complex(self, n, args, kwargs):
        return Complex(args[0], args[1])

    def op_fft_irfft(self, n, args, kwargs):
        z = args[0]
        length = args[1] if len(args) > 1 else kwargs.get("n")
        dim = args[2] if len(args) > 2 else kwargs.get("dim", -1)
        norm = args[3] if len(args) > 3 else kwargs.get("norm")
        if not isinstance(z, Complex) or dim % z.re.ndim != z.re.ndim - 1:
            raise NotImplementedError("an inverse real FFT over the last "
                                      "axis of aten.complex")
        n_bins = z.re.val.shape[-1]
        length = 2 * (n_bins - 1) if length is None else length
        if n_bins != length // 2 + 1:
            raise NotImplementedError("an inverse real FFT of a truncated "
                                      "spectrum")
        cos_m, sin_m = irdft_mats(int(length))
        scale = {None: 1.0, "backward": 1.0, "ortho": math.sqrt(length),
                 "forward": float(length)}[norm]
        if scale != 1.0:
            cos_m, sin_m = cos_m * np.float32(scale), sin_m * np.float32(scale)
        return self.sym(self.node("Sub", [
            self.node("MatMul", [self.tensor(z.re), self.const(cos_m)]),
            self.node("MatMul", [self.tensor(z.im), self.const(sin_m)])]), n)


# ---------------------------------------------------------------------------


class _Fn(nn.Module):
    """A plain function as a module, for torch.export."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _dim_name(expr, names: dict) -> str:
    if expr in names:
        return names[expr]
    text = str(expr)
    for sym in sorted(expr.free_symbols, key=lambda s: -len(str(s))):
        if sym in names:
            text = re.sub(rf"\b{sym}\b", names[sym], text)
    return text


class Traced:
    """One ``torch.export`` trace of a module at its example arguments;
    :meth:`onnx` converts it (as often as asked)."""

    def __init__(self, ep, input_names, example_args, dynamic_axes):
        self.ep = ep
        self.input_names = list(input_names)
        self.example_args = example_args
        self.dynamic_axes = dynamic_axes

    def onnx(self, output_names: Sequence[str], *, graph_name: str = "graph",
             opset: int = 16, doc: str = "",
             producer: str = "diffsvc_tpu_torch",
             state: Optional[dict] = None) -> bytes:
        """ModelProto bytes.  ``state`` {state-dict name: tensor} replaces
        those parameters or buffers (a planted fault on a copy of the
        weights), names as the traced module's ``state_dict`` has them."""
        ep = self.ep
        gm, sig = ep.graph_module, ep.graph_signature
        state = dict(state or {})
        b = GraphBuilder(graph_name, opset=opset, producer=producer)
        env, names, dim_names = {}, {}, {}
        user = []
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        for n, spec in zip(placeholders, sig.input_specs):
            kind = spec.kind.name
            if kind == "USER_INPUT":
                user.append(n)
                continue
            if kind not in ("PARAMETER", "BUFFER", "CONSTANT_TENSOR"):
                raise NotImplementedError(f"graph input of kind {kind}")
            t = state.pop(spec.target, None)
            if t is None:
                t = ep.state_dict[spec.target] \
                    if spec.target in ep.state_dict \
                    else ep.constants[spec.target]
            env[n.name] = t
            if kind != "CONSTANT_TENSOR":
                names[id(t)] = spec.target
        if state:
            raise KeyError(f"not parameters of the traced module: "
                           f"{sorted(state)}")
        for n, name, arg in zip(user, self.input_names, self.example_args):
            val = n.meta["val"]
            dims = []
            for ax, size in enumerate(val.shape):
                if ax in self.dynamic_axes.get(name, ()):
                    dims.append(f"{name}_dyn_{ax}")
                    dim_names.setdefault(size.node.expr, dims[-1])
                else:
                    dims.append(int(size))
            b.add_input(name, _onnx_type(arg.dtype), dims)
            env[n.name] = Sym(name, val)

        conv = Converter(b, names)
        outs = conv.run(gm, env)
        if len(output_names) != len(outs):
            raise ValueError(f"{len(outs)} outputs traced, "
                             f"{len(output_names)} names given")
        for name, val in zip(output_names, outs):
            if isinstance(val, torch.Tensor):
                b.add_node("Identity", [conv.tensor(val)], outputs=[name])
                shape, dtype = [int(s) for s in val.shape], val.dtype
            elif isinstance(val, Sym):
                b.add_node("Identity", [val.name], outputs=[name])
                shape = [int(s) if not isinstance(s, torch.SymInt)
                         else _dim_name(s.node.expr, dim_names)
                         for s in val.val.shape]
                dtype = val.dtype
            else:
                raise NotImplementedError(f"graph output {val!r}")
            b.add_output(name, _onnx_type(dtype), shape)
        return b.model_bytes(doc=doc)


def trace(module, example_args, *, input_names: Sequence[str],
          dynamic_axes: Optional[Dict[str, Sequence[int]]] = None) -> Traced:
    """``torch.export`` of ``module(*example_args)`` (CPU tensors at the
    trace shape), each axis of ``dynamic_axes`` {input name: [axis, ...]}
    traced as a dynamic size and checked to stay one."""
    from torch.export import Dim, export

    dynamic_axes = {k: list(v) for k, v in (dynamic_axes or {}).items()}
    if len(input_names) != len(example_args):
        raise ValueError("need one input name per argument")
    mod = module if isinstance(module, nn.Module) else _Fn(module)
    # distinct tensors: torch.export ties an argument passed twice to itself
    example_args = tuple(a.detach().clone() for a in example_args)
    dyn = tuple({ax: Dim.AUTO for ax in dynamic_axes.get(name, ())} or None
                for name in input_names)
    with torch.no_grad():
        # once eagerly first: the device caches that some modules keep by
        # shape (ops/istft.py's envelope, ops/mel.py's window) then hold
        # real tensors, which the trace lifts as constants, and not the
        # trace's fake ones
        mod(*example_args)
        ep = export(mod, example_args, strict=False,
                    dynamic_shapes={"args": dyn} if isinstance(mod, _Fn)
                    else dyn)
    user = [n for n, spec in zip(
        (n for n in ep.graph.nodes if n.op == "placeholder"),
        ep.graph_signature.input_specs) if spec.kind.name == "USER_INPUT"]
    if len(user) != len(input_names):
        raise ValueError(f"{len(user)} inputs traced, {len(input_names)} "
                         "names given")
    for n, name, arg in zip(user, input_names, example_args):
        for ax in dynamic_axes.get(name, ()):
            size = n.meta["val"].shape[ax]
            if not (isinstance(size, torch.SymInt)
                    and size.node.expr.free_symbols):
                raise ValueError(f"{name} axis {ax} is dynamic, but the "
                                 "traced program fixes it at "
                                 f"{int(arg.shape[ax])}")
    return Traced(ep, input_names, example_args, dynamic_axes)


def export_onnx(module, example_args, *, input_names: Sequence[str],
                output_names: Sequence[str], graph_name: str = "graph",
                dynamic_axes: Optional[Dict[str, Sequence[int]]] = None,
                opset: int = 16, doc: str = "",
                producer: str = "diffsvc_tpu_torch") -> bytes:
    """Export ``module(*example_args)`` to ONNX ModelProto bytes.

    :param module: an ``nn.Module`` (its parameters and buffers become
        initializers) or a function of tensors
    :param example_args: one CPU tensor per graph input, at the trace shape
    :param input_names: one name per argument; ``output_names`` one per
        output
    :param dynamic_axes: {input name: [axis, ...]} traced as dynamic sizes
        (the reference's torch.onnx convention); every other axis is fixed
    """
    return trace(module, example_args, input_names=input_names,
                 dynamic_axes=dynamic_axes).onnx(
        output_names, graph_name=graph_name, opset=opset, doc=doc,
        producer=producer)
