"""K4: the DiffNet residual stack for training — hand-written Hopper kernels
(forward with save, batch-fused backward) + their plain PyTorch versions.

Replaces ``diffsvc_tpu/ops/pallas/diffnet_stack.py:residual_stack_train_batched``
(forward ``_fwd_kernel`` via ``_call_fwd``, backward ``_bwd_kernel_b`` via
``_call_bwd_batched``, custom VJP ``_rstb_fwd``/``_rstb_bwd``).  CUDA source:
``csrc/diffnet_stack_train.cu`` (+ the layer kernels of
``csrc/diffnet_layer.cuh``, shared with K6, and the backward of
``csrc/diffnet_train_bwd.cuh``, shared with K5).  The forward with save is
also K5's forward (``diffnet_stack_per_sample``), as ``_call_fwd`` serves
both JAX routes.

- Forward: K1's layer math with the residual state x in x0's dtype (f32 in
  training) and every matmul operand in the *stream* dtype (``wd.dtype``:
  bf16 or f32); each layer's input x_l is saved, rounded to the stream
  dtype, into ``xsave`` [L, B, T, C].
- Backward: layers in reverse; z and the gates are recomputed from the
  saved x_l; ``do``, ``dz`` and ``h`` are rounded to the stream dtype before
  the products; weight and bias grads are summed over the whole batch in
  f32; the dx carry is f32 and comes back as dx0.  Every reduction sums in
  a fixed order (no atomics), so a step repeats bit for bit.

What bounds it on the H100: FLOPs on the CUDA cores (SIMT FMAs; the products
are ~4.4 TFLOP per step at B=24, T=1024, C=384, L=20), like K1.  Tensor
cores are later work.

Layout differences from the TPU kernel: ``xsave`` is layer-major
[L, B, T, C] (the TPU's is [B, L, T, C]), so each layer's slice is one
contiguous block; any T and C.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build
from .diffnet_stack import _DTYPES, residual_stack

launches = 0       # kernel launches (forward and backward calls on CUDA tensors)
bwd_launches = 0   # of which batch-fused backward calls

RCH = 2048     # rows per partial sum of the weight-grad contractions
CCH = 128      # rows per partial sum of the bias / step-bias column sums
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_PAIRS = {(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
          (torch.bfloat16, torch.bfloat16)}   # (state, stream) dtypes


def stream_dtype(name: str, state_dtype: torch.dtype) -> torch.dtype:
    """``diffnet_train_stream_dtype`` -> torch dtype: "bf16" streams bf16,
    anything else streams in the state's own dtype (the JAX ``_sd``)."""
    return torch.bfloat16 if name == "bf16" else state_dtype


def _shift(y, s: int):
    """out[:, t] = y[:, t - s], zero where t - s falls outside [0, T)."""
    t = y.shape[1]
    if s >= 0:
        return F.pad(y, (0, 0, s, 0))[:, :t]
    return F.pad(y, (0, 0, 0, -s))[:, -s:t - s]


def _taps(x, sb_l, d: int, sd):
    """(y[t-d], y[t], y[t+d]) in f32 with values rounded to ``sd``;
    y = x + sb_l."""
    y = (x.float() + sb_l[:, None, :].float()).to(sd).float()
    return _shift(y, d), y, _shift(y, -d)


def residual_stack_train_fwd_plain(x0, sb, cond_proj, wd, bd, wo, bo, *,
                                   cycle: int):
    """Plain version of the forward with the TPU kernel's rounding points
    (``_fwd_kernel``): x in x0's dtype, y/h rounded to the stream dtype
    (``wd.dtype``), z and o in f32, skip summed in f32.  Returns (skip
    [B,T,C] f32, xsave [L,B,T,C] in the stream dtype)."""
    sd = wd.dtype
    n_layers, b, t, c2 = cond_proj.shape
    c = c2 // 2
    x = x0
    skip = torch.zeros(b, t, c, dtype=torch.float32, device=x0.device)
    xsave = torch.empty(n_layers, b, t, c, dtype=sd, device=x0.device)
    for layer in range(n_layers):
        d = 2 ** (layer % cycle)
        xsave[layer] = x.to(sd)
        yl, y, yr = _taps(x, sb[layer], d, sd)
        w = wd[layer].float()
        z = yl @ w[0] + y @ w[1] + yr @ w[2]
        z = z + bd[layer].float() + cond_proj[layer].float()
        h = (torch.sigmoid(z[..., :c]) * torch.tanh(z[..., c:])).to(sd)
        o = h.float() @ wo[layer].float() + bo[layer].float()
        x = ((x.float() + o[..., :c]) * _INV_SQRT2).to(x0.dtype)
        skip = skip + o[..., c:]
    return skip, xsave


def bwd_plain(xsave, sb, cond_proj, wd, bd, wo, dout, *, cycle: int,
              dcp_dtype):
    """The explicit backward's math (``_bwd_kernel_b``, ``_bwd_kernel``),
    not autograd: y is recomputed from the saved, rounded x_l; do, dz and h
    are rounded to the stream dtype (``wd.dtype``) before the products; dcp
    is stored in ``dcp_dtype``.  Returns dx0 [B,T,C] f32, dsb [L,B,C] f32,
    dcp [L,B,T,2C] and dwd/dbd/dwo/dbo summed over the given batch in f32."""
    sd = wd.dtype
    n_layers, b, t, c2 = cond_proj.shape
    c = c2 // 2
    dev = xsave.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.zeros(b, t, c, **f32)
    dsb = torch.empty(n_layers, b, c, **f32)
    dcp = torch.empty(n_layers, b, t, c2, dtype=dcp_dtype, device=dev)
    dwd = torch.empty(n_layers, 3, c, c2, **f32)
    dbd = torch.empty(n_layers, c2, **f32)
    dwo = torch.empty(n_layers, c, c2, **f32)
    dbo = torch.empty(n_layers, c2, **f32)
    for layer in reversed(range(n_layers)):
        d = 2 ** (layer % cycle)
        taps = _taps(xsave[layer], sb[layer], d, sd)
        w = wd[layer].float()
        z = taps[0] @ w[0] + taps[1] @ w[1] + taps[2] @ w[2]
        z = z + bd[layer].float() + cond_proj[layer].float()
        s = torch.sigmoid(z[..., :c])
        tf = torch.tanh(z[..., c:])
        h = (s * tf).to(sd).float()
        do = torch.cat([dx * _INV_SQRT2, dout.float()], dim=-1)
        do_c = do.to(sd).float()
        dwo[layer] = h.reshape(-1, c).T @ do_c.reshape(-1, c2)
        dbo[layer] = do.sum((0, 1))
        dh = do_c @ wo[layer].float().T
        dz = torch.cat([dh * s * (1.0 - s) * tf, dh * s * (1.0 - tf * tf)],
                       dim=-1)
        dcp[layer] = dz.to(dcp_dtype)
        dbd[layer] = dz.sum((0, 1))
        dz_c = dz.to(sd).float()
        for j in range(3):
            dwd[layer, j] = taps[j].reshape(-1, c).T @ dz_c.reshape(-1, c2)
        dy = (_shift(dz_c, -d) @ w[0].T + dz_c @ w[1].T
              + _shift(dz_c, d) @ w[2].T)
        dsb[layer] = dy.sum(1)
        dx = dy + dx * _INV_SQRT2
    return dx, dsb, dcp, dwd, dbd, dwo, dbo


def residual_stack_train_batched_bwd_plain(xsave, sb, cond_proj, wd, bd, wo,
                                           dout, *, cycle: int):
    """Plain version of the batch-fused backward: :func:`bwd_plain` with
    ``dout`` [B,T,C] and dcp in the stream dtype."""
    return bwd_plain(xsave, sb, cond_proj, wd, bd, wo, dout, cycle=cycle,
                     dcp_dtype=wd.dtype)


def _check(x0, sb, cond_proj, wd, bd, wo, bo):
    sd = wd.dtype
    if (x0.dtype, sd) not in _PAIRS:
        raise TypeError(f"residual_stack_train: state {x0.dtype} with stream "
                        f"{sd} is not supported")
    b, t, c = x0.shape
    n_layers = cond_proj.shape[0]
    shapes = {"cond_proj": (cond_proj, (n_layers, b, t, 2 * c)),
              "wd": (wd, (n_layers, 3, c, 2 * c)), "bd": (bd, (n_layers, 2 * c)),
              "wo": (wo, (n_layers, c, 2 * c)), "bo": (bo, (n_layers, 2 * c)),
              "sb": (sb, (n_layers, b, c))}
    for name, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"residual_stack_train: {name} "
                             f"{tuple(a.shape)} != {shape}")
        if a.device != x0.device:
            raise ValueError(f"residual_stack_train: {name} is on {a.device}, "
                             f"x0 on {x0.device}")
    for name, a in (("x0", x0), ("cond_proj", cond_proj), ("wd", wd),
                    ("wo", wo)):
        if not a.is_contiguous():
            raise ValueError(f"residual_stack_train: {name} must be contiguous")
    for name, a in (("cond_proj", cond_proj), ("wo", wo)):
        if a.dtype != sd:
            raise ValueError(f"residual_stack_train: {name} is {a.dtype}, "
                             f"the stream dtype (wd) is {sd}")
    for name, a in (("sb", sb), ("bd", bd), ("bo", bo)):
        if not a.is_floating_point():
            raise ValueError(f"residual_stack_train: {name} must be floating")


def on_card(x0, what: str) -> bool:
    """True for CUDA (launch), False for CPU (plain version); raises on any
    other device."""
    if x0.device.type == "cpu":
        return False
    if x0.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x0.device}")
    return True


def residual_stack_train_fwd(x0, sb, cond_proj, wd, bd, wo, bo, *,
                             cycle: int):
    """Forward with save: (skip [B,T,C] f32, xsave [L,B,T,C]).

    :param x0: [B, T, C] state (f32, or bf16 with a bf16 stream)
    :param sb: [L, B, C] step bias; bd / bo [L, 2C] biases (any float dtype)
    :param cond_proj, wd, wo: [L,B,T,2C], [L,3,C,2C], [L,C,2C] in the stream
        dtype (bf16 or f32), contiguous
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global launches
    _check(x0, sb, cond_proj, wd, bd, wo, bo)
    if not on_card(x0, "residual_stack_train_fwd"):
        return residual_stack_train_fwd_plain(x0, sb, cond_proj, wd, bd, wo,
                                              bo, cycle=cycle)
    b, t, c = x0.shape
    n_layers, sd = cond_proj.shape[0], wd.dtype
    x = x0.clone()                                  # running state, in place
    h = torch.empty(b, t, c, dtype=sd, device=x0.device)
    skip = torch.empty(b, t, c, dtype=torch.float32, device=x0.device)
    xsave = torch.empty(n_layers, b, t, c, dtype=sd, device=x0.device)
    sbf, bdf, bof = (a.float().contiguous() for a in (sb, bd, bo))
    err = _build.lib().dsvc_stack_train_fwd(
        _DTYPES[x0.dtype], _DTYPES[sd], x.data_ptr(), h.data_ptr(),
        skip.data_ptr(), xsave.data_ptr(), sbf.data_ptr(), b * c, c,
        cond_proj.data_ptr(), wd.data_ptr(), bdf.data_ptr(), wo.data_ptr(),
        bof.data_ptr(), b, t, c, n_layers, cycle, _build.stream())
    _build.check(err, "dsvc_stack_train_fwd")
    launches += 1
    return skip, xsave


def check_bwd(xsave, sb, cond_proj, wd, bd, wo, dout, dout_dtype,
              what: str) -> None:
    """Shapes, devices and dtypes of a backward's operands: ``xsave``,
    ``cond_proj``, ``wd`` and ``wo`` in the stream dtype, ``dout`` [B,T,C]
    in ``dout_dtype``, contiguous."""
    # dout stands in for the state: shapes, devices, a valid dtype pair
    _check(dout, sb, cond_proj, wd, bd, wo, bd)
    if tuple(xsave.shape) != (cond_proj.shape[0], *dout.shape):
        raise ValueError(f"{what}: xsave {tuple(xsave.shape)} does not match "
                         "dout")
    for name, a, dt in (("xsave", xsave, wd.dtype), ("dout", dout, dout_dtype)):
        if a.dtype != dt or not a.is_contiguous() or a.device != wd.device:
            raise ValueError(f"{what}: {name} must be contiguous {dt} on "
                             f"{wd.device}")


def bwd_scratch(b: int, t: int, c: int, seg_rows: int, sd, dev):
    """Scratch of the backward (``diffnet_train_bwd.cuh:run_bwd``) with
    weight-grad segments of ``seg_rows`` rows, in the C entry points'
    order: z, h, do, dy, wpart, cpart."""
    rows = b * t
    nseg = rows // seg_rows
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty(rows, 2 * c, **f32),
            torch.empty(rows, c, dtype=sd, device=dev),
            torch.empty(rows, 2 * c, **f32), torch.empty(rows, c, **f32),
            torch.empty(nseg * -(-seg_rows // RCH), 3 * c, 2 * c, **f32),
            torch.empty(max(nseg * -(-seg_rows // CCH) * 2 * c,
                            b * -(-t // CCH) * c), **f32))


def bwd_outputs(n_layers: int, b: int, t: int, c: int, dcp_dtype, dev):
    """(dx0, dsb, dcp, dwd, dbd, dwo, dbo), uninitialised, on ``dev``."""
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty(b, t, c, **f32), torch.empty(n_layers, b, c, **f32),
            torch.empty(n_layers, b, t, 2 * c, dtype=dcp_dtype, device=dev),
            torch.empty(n_layers, 3, c, 2 * c, **f32),
            torch.empty(n_layers, 2 * c, **f32),
            torch.empty(n_layers, c, 2 * c, **f32),
            torch.empty(n_layers, 2 * c, **f32))


def residual_stack_train_batched_bwd(xsave, sb, cond_proj, wd, bd, wo, dout,
                                     *, cycle: int):
    """Batch-fused backward: (dx0, dsb, dcp, dwd, dbd, dwo, dbo) as
    :func:`residual_stack_train_batched_bwd_plain` returns them.  ``xsave``,
    ``cond_proj``, ``wd``, ``wo`` and ``dout`` in the stream dtype."""
    global launches, bwd_launches
    n_layers, b, t, c = xsave.shape
    check_bwd(xsave, sb, cond_proj, wd, bd, wo, dout, wd.dtype,
              "residual_stack_train_batched_bwd")
    if not on_card(xsave, "residual_stack_train_batched_bwd"):
        return residual_stack_train_batched_bwd_plain(
            xsave, sb, cond_proj, wd, bd, wo, dout, cycle=cycle)
    sd = wd.dtype
    out = bwd_outputs(n_layers, b, t, c, sd, xsave.device)
    scratch = bwd_scratch(b, t, c, b * t, sd, xsave.device)
    sbf, bdf = sb.float().contiguous(), bd.float().contiguous()
    err = _build.lib().dsvc_stack_train_bwd(
        _DTYPES[sd], xsave.data_ptr(), sbf.data_ptr(), cond_proj.data_ptr(),
        wd.data_ptr(), bdf.data_ptr(), wo.data_ptr(), dout.data_ptr(),
        *(a.data_ptr() for a in out), *(a.data_ptr() for a in scratch),
        b, t, c, n_layers, cycle, RCH, CCH, _build.stream())
    _build.check(err, "dsvc_stack_train_bwd")
    launches += 1
    bwd_launches += 1
    return out


class ResidualStackTrainFn(torch.autograd.Function):
    """Differentiable residual stack of both training routes (the JAX custom
    VJPs of ``residual_stack_train_batched`` and ``residual_stack_train``):
    the forward saves x_l with cond_proj, wd and wo rounded to the stream
    dtype ``sd`` on the way in; the backward is ``bwd`` (K4's batch-fused or
    K5's per-sample kernel) with the skip cotangent cast to ``dout_dtype``.
    Cotangents come back in the primal dtypes."""

    @staticmethod
    def forward(ctx, x0, sb, cond_proj, wd, bd, wo, bo, cycle: int, sd, bwd,
                dout_dtype):
        cp, wds, wos = (a.to(sd).contiguous() for a in (cond_proj, wd, wo))
        skip, xsave = residual_stack_train_fwd(x0.contiguous(), sb, cp, wds,
                                               bd, wos, bo, cycle=cycle)
        ctx.save_for_backward(xsave, sb, cp, wds, bd, wos)
        ctx.cycle, ctx.bwd, ctx.dout_dtype = cycle, bwd, dout_dtype
        ctx.dtypes = tuple(a.dtype for a in (x0, sb, cond_proj, wd, bd, wo,
                                             bo))
        return skip

    @staticmethod
    def backward(ctx, dout):
        xsave, sb, cp, wds, bd, wos = ctx.saved_tensors
        grads = ctx.bwd(xsave, sb, cp, wds, bd, wos,
                        dout.to(ctx.dout_dtype).contiguous(), cycle=ctx.cycle)
        return (*(g.to(dt) for g, dt in zip(grads, ctx.dtypes)),
                None, None, None, None)


def primal(x0, sb, cond_proj, wd, bd, wo, bo, *, cycle: int, sd):
    """The undifferentiated primal of the training routes (validation's
    loss): K1 (:func:`diffnet_stack.residual_stack`) in the state's dtype
    with cond_proj, wd and wo rounded through ``sd``, as the JAX primal runs
    it (``diffnet_stack.py:442-454`` and ``:693-716``)."""
    xd = x0.dtype
    cp, wds, wos = (a.to(sd).to(xd).contiguous() for a in (cond_proj, wd, wo))
    sbx, bdx, box = (a.to(xd).contiguous() for a in (sb, bd, bo))
    return residual_stack(x0.contiguous(), sbx, cp, wds, bdx, wos, box,
                          cycle=cycle)


def train_stack(args, *, cycle: int, sd, bwd, dout_dtype):
    """A training route of the residual stack on ``args`` = (x0, sb,
    cond_proj, wd, bd, wo, bo): [B,T,C] f32 skip sum.  With grad enabled and
    an input that requires it, :class:`ResidualStackTrainFn` with the
    route's stream dtype, backward and cotangent dtype; without (validation's
    loss), :func:`primal` with the stream dtype."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return ResidualStackTrainFn.apply(*args, cycle, sd, bwd, dout_dtype)
    return primal(*args, cycle=cycle, sd=sd)


def residual_stack_train_batched(x0, sb, cond_proj, wd, bd, wo, bo, *,
                                 cycle: int, stream: str = "bf16"):
    """The batched training route of the residual stack: [B,T,C] f32 skip
    sum, streamed in ``stream``; the backward is the batch-fused kernel with
    the cotangent in the stream dtype (:func:`train_stack`)."""
    sd = stream_dtype(stream, x0.dtype)
    return train_stack((x0, sb, cond_proj, wd, bd, wo, bo), cycle=cycle,
                       sd=sd, bwd=residual_stack_train_batched_bwd,
                       dout_dtype=sd)
