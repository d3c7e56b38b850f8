"""K6: one gated DiffNet residual block — hand-written Hopper kernels + their
plain PyTorch version.

Replaces ``diffsvc_tpu/ops/pallas/diffnet_block.py:fused_residual_block``
(kernel ``_make_kernel``).  CUDA source: ``csrc/diffnet_block.cu``.  No
path of the JAX package runs it (the stack kernels K1/K4/K5 superseded it);
the port keeps it with the same contract and no route.

Rounding follows the TPU kernel: y = x + step rounded to x's dtype before
the taps; z in f32; h rounded to x's dtype; o[:, :C] rounded to x's dtype
before the residual add, and skip returned per layer in x's dtype.  The
TPU kernel's pre-padded copy of y and its ``T % tile`` assert are not
carried over: the taps read t +- d with zeros outside [0, T), for any T.

What bounds it on the H100: tensor-core operations, 16 C^2 FLOPs per row
(~2.4 GFLOP at T=1024, C=384).  It runs one layer of K1's routes on
``wgmma`` (K1's launch plan ``diffnet_stack.tc_plan``): bf16 operands with
f32 sums at bf16 (K1's gate kernel, an output kernel with K6's rounding
points), 3xTF32 split products at f32 (K1's layer as it is).  The weights
are packed as K1's (``diffnet_stack.pack_layers``; at f32 also split into
hi and lo planes), once per weight tensor and version: a one-layer pack
is ~20 small launches and takes longer than the kernels (2-4 calls' time
on the H100), so ``packed_weights`` keeps the result while the weight
tensors live and are not changed in place.
"""

from __future__ import annotations

import math
import weakref

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import _build
from . import diffnet_stack as ds
from .diffnet_stack_train import _shift, on_card

launches = 0          # kernel launches (block calls on CUDA tensors)
launches_tc = 0       # of those, the bf16 ones on the tensor-core kernels
launches_tf32x3 = 0   # of those, the f32 ones on the 3xTF32 kernels

# w_dil -> (weakref to w_out, (both weights' versions and data pointers,
# cp) at the pack, (packed w_dil, packed w_out)); an entry dies with its
# w_dil
_packed = WeakIdKeyDictionary()


def fused_residual_block_plain(x, step, cond_proj, w_dil, b_dil, w_out,
                               b_out, *, dilation: int, matmul=torch.matmul):
    """Plain version with the TPU kernel's rounding points: (x', skip).
    ``matmul`` computes the products (``diffnet_stack.matmul_tf32x3``: the
    f32 kernels' arithmetic)."""
    dt, c, d = x.dtype, x.shape[-1], dilation
    y = (x.float() + step.float()[:, None, :]).to(dt).float()
    w = w_dil.float()
    z = (matmul(_shift(y, d), w[0]) + matmul(y, w[1])
         + matmul(_shift(y, -d), w[2]))
    z = z + b_dil.float() + cond_proj.float()
    h = (torch.sigmoid(z[..., :c]) * torch.tanh(z[..., c:])).to(dt).float()
    o = matmul(h, w_out.float()) + b_out.float()
    inv = torch.tensor(1.0 / math.sqrt(2.0), dtype=dt).float()
    res = (x.float() + o[..., :c].to(dt).float()).to(dt).float()
    return (res * inv).to(dt), o[..., c:].to(dt)


def pack_weights(w_dil, w_out, cp: int):
    """(w_dil [3, C, 2C], w_out [C, 2C]) as the kernels read them: K1's
    packing of one layer, [2cp, 3cp] and [2cp, cp], at f32 as hi and lo
    planes [2, 2cp, 3cp] and [2, 2cp, cp]."""
    wd, wo = ds.pack_layers(w_dil[None], w_out[None], cp)
    return wd[0], wo[0]


def packed_weights(w_dil, w_out, cp: int):
    """``pack_weights``, kept per (w_dil, w_out) pair of tensors: packed
    again when either is another tensor or has changed in place (its
    ``_version``) since the last pack."""
    state = (w_dil._version, w_out._version, w_dil.data_ptr(),
             w_out.data_ptr(), cp)
    hit = _packed.get(w_dil)
    if hit is not None and hit[0]() is w_out and hit[1] == state:
        return hit[2]
    wd, wo = pack_weights(w_dil, w_out, cp)
    _packed[w_dil] = (weakref.ref(w_out), state, (wd, wo))
    return wd, wo


def _check(x, step, cond_proj, w_dil, b_dil, w_out, b_out):
    if x.dtype not in ds._DTYPES:
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
    plain version; CUDA tensors launch the tensor-core kernels (bf16
    operands, or f32 as 3xTF32 split products).
    """
    global launches, launches_tc, launches_tf32x3
    _check(x, step, cond_proj, w_dil, b_dil, w_out, b_out)
    if not on_card(x, "fused_residual_block"):
        return fused_residual_block_plain(x, step, cond_proj, w_dil, b_dil,
                                          w_out, b_out, dilation=dilation)
    b, t, c = x.shape
    plan = ds.tc_plan(b, t, c, dtype=x.dtype)
    wd, wo = packed_weights(w_dil, w_out, plan.cp)
    y, h = ds.layer_scratch(b, t, plan.cp, x.dtype, x.device)
    x_out, skip = torch.empty_like(x), torch.empty_like(x)
    err = _build.lib().dsvc_residual_block(
        ds._DTYPES[x.dtype], x.data_ptr(), step.data_ptr(),
        cond_proj.data_ptr(), wd.data_ptr(), b_dil.data_ptr(), wo.data_ptr(),
        b_out.data_ptr(), y.data_ptr(), h.data_ptr(), x_out.data_ptr(),
        skip.data_ptr(), b, t, c, dilation, plan.c_array(), _build.stream())
    _build.check(err, "dsvc_residual_block")
    launches += 1
    launches_tc += x.dtype == torch.bfloat16
    launches_tf32x3 += x.dtype == torch.float32
    return x_out, skip
