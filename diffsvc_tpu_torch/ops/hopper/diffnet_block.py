"""K6: one gated DiffNet residual block — hand-written Hopper kernel + its
plain PyTorch version.

Replaces ``diffsvc_tpu/ops/pallas/diffnet_block.py:fused_residual_block``
(kernel ``_make_kernel``).  CUDA source: ``csrc/diffnet_block.cu`` (the SIMT
gate kernel of ``csrc/diffnet_layer.cuh`` and its own output epilogue).  No
path of the JAX package runs it (the stack kernels K1/K4/K5 superseded it);
the port keeps it with the same contract and no route.

Rounding follows the TPU kernel: y = x + step rounded to x's dtype before
the taps; z in f32; h rounded to x's dtype; o[:, :C] rounded to x's dtype
before the residual add, and skip returned per layer in x's dtype.  The
TPU kernel's pre-padded copy of y and its ``T % tile`` assert are not
carried over: the taps read t +- d with zeros outside [0, T), for any T.

What bounds it on the H100: 16 C^2 FLOPs per row (~2.4 GFLOP at T=1024,
C=384): in f32 the operation count (67 TFLOP/s), in bf16 the ~12 MB it
must move; the SIMT tiles run far from either (tensor cores are later
work).
"""

from __future__ import annotations

import math

import torch

from . import _build
from .diffnet_stack import _DTYPES
from .diffnet_stack_train import _shift, on_card

launches = 0   # kernel launches (block calls on CUDA tensors)


def fused_residual_block_plain(x, step, cond_proj, w_dil, b_dil, w_out,
                               b_out, *, dilation: int):
    """Plain version with the TPU kernel's rounding points: (x', skip)."""
    dt, c, d = x.dtype, x.shape[-1], dilation
    y = (x.float() + step.float()[:, None, :]).to(dt).float()
    w = w_dil.float()
    z = _shift(y, d) @ w[0] + y @ w[1] + _shift(y, -d) @ w[2]
    z = z + b_dil.float() + cond_proj.float()
    h = (torch.sigmoid(z[..., :c]) * torch.tanh(z[..., c:])).to(dt).float()
    o = h @ w_out.float() + b_out.float()
    inv = torch.tensor(1.0 / math.sqrt(2.0), dtype=dt).float()
    res = (x.float() + o[..., :c].to(dt).float()).to(dt).float()
    return (res * inv).to(dt), o[..., c:].to(dt)


def _check(x, step, cond_proj, w_dil, b_dil, w_out, b_out):
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_residual_block: unsupported dtype {x.dtype}")
    b, t, c = x.shape
    shapes = {"step": (step, (b, c)), "cond_proj": (cond_proj, (b, t, 2 * c)),
              "w_dil": (w_dil, (3, c, 2 * c)), "b_dil": (b_dil, (2 * c,)),
              "w_out": (w_out, (c, 2 * c)), "b_out": (b_out, (2 * c,))}
    for name, (a, shape) in {"x": (x, (b, t, c)), **shapes}.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"fused_residual_block: {name} "
                             f"{tuple(a.shape)} != {shape}")
        if a.dtype != x.dtype or a.device != x.device \
                or not a.is_contiguous():
            raise ValueError(f"fused_residual_block: {name} must be a "
                             f"contiguous {x.dtype} tensor on {x.device}")


def fused_residual_block(x, step, cond_proj, w_dil, b_dil, w_out, b_out, *,
                         dilation: int):
    """One residual layer: (x' [B,T,C], skip [B,T,C]), both in x's dtype.

    :param x: [B, T, C] activations (f32 or bf16)
    :param step: [B, C] diffusion-step bias of this layer
    :param cond_proj: [B, T, 2C] conditioner projection of this layer
    :param w_dil, b_dil: [3, C, 2C] taps (t-d, t, t+d), [2C]
    :param w_out, b_out: [C, 2C], [2C] output 1x1
    All in x's dtype, contiguous, on x's device.  CPU tensors take the
    plain version; CUDA tensors launch the kernel.
    """
    global launches
    _check(x, step, cond_proj, w_dil, b_dil, w_out, b_out)
    if not on_card(x, "fused_residual_block"):
        return fused_residual_block_plain(x, step, cond_proj, w_dil, b_dil,
                                          w_out, b_out, dilation=dilation)
    b, t, c = x.shape
    h, x_out, skip = (torch.empty_like(x) for _ in range(3))
    err = _build.lib().dsvc_residual_block(
        _DTYPES[x.dtype], x.data_ptr(), step.data_ptr(), cond_proj.data_ptr(),
        w_dil.data_ptr(), b_dil.data_ptr(), w_out.data_ptr(),
        b_out.data_ptr(), h.data_ptr(), x_out.data_ptr(), skip.data_ptr(),
        b, t, c, dilation, _build.stream())
    _build.check(err, "dsvc_residual_block")
    launches += 1
    return x_out, skip
