"""K1: the DiffNet residual stack — hand-written Hopper kernel + plain twin.

Replaces ``diffsvc_tpu/ops/pallas/diffnet_stack.py:residual_stack`` (Pallas
kernel ``_kernel``): the L gated residual layers of one denoiser evaluation,
returning the f32 skip sum.  CUDA source: ``csrc/diffnet_stack.cu``.

What bounds it on the H100: arithmetic.  At T=1024, C=384, L=20 one call is
~48 GFLOP against ~30 MB of bf16 weights and conditioner, far above the
card's FLOP-per-byte line.  This first kernel runs the products as
shared-memory tiled SIMT GEMMs on the CUDA cores with f32 accumulation (true
f32 for f32 operands, exact bf16 products for bf16), two launches per layer
(gate, output projection); the TPU kernel's VMEM residency becomes an L2
working set (x, h and skip are ~2-4 MB at the main path's shapes).  Tensor
cores (wgmma) and a fused per-layer kernel are later work.

Differences from the TPU kernel: takes [B, T, C] directly (the TPU kernel is
B=1 and is vmapped), any T and C, and f32 as well as bf16 operands (on
Hopper an f32 kernel is true f32, so there is no bf16-only gate).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build

launches = 0   # kernel launches (one per stack call on a CUDA tensor)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def residual_stack_plain(x0, sb, cond_proj, wd, bd, wo, bo, *, cycle: int):
    """Plain PyTorch version with the kernel's rounding points: matmul
    operands in the compute dtype, products summed in f32, running x
    rounded to the compute dtype after every layer, skip in f32."""
    dt = x0.dtype
    n_layers, b, t, c2 = cond_proj.shape
    c = c2 // 2
    x = x0
    skip = torch.zeros(b, t, c, dtype=torch.float32, device=x0.device)
    for layer in range(n_layers):
        d = 2 ** (layer % cycle)
        y = (x.float() + sb[layer][:, None, :].float()).to(dt).float()
        yl = F.pad(y, (0, 0, d, 0))[:, :t]           # y[t-d], zero outside
        yr = F.pad(y, (0, 0, 0, d))[:, d:d + t]      # y[t+d], zero outside
        w = wd[layer].float()
        z = yl @ w[0] + y @ w[1] + yr @ w[2]
        z = z + bd[layer].float() + cond_proj[layer].float()
        h = (torch.sigmoid(z[..., :c]) * torch.tanh(z[..., c:])).to(dt)
        o = h.float() @ wo[layer].float() + bo[layer].float()
        x = ((x.float() + o[..., :c]) * (1.0 / math.sqrt(2.0))).to(dt)
        skip = skip + o[..., c:]
    return skip


def _check(x0, sb, cond_proj, wd, bd, wo, bo):
    if x0.dtype not in _DTYPES:
        raise TypeError(f"residual_stack: unsupported dtype {x0.dtype}")
    b, t, c = x0.shape
    n_layers = cond_proj.shape[0]
    shapes = {"cond_proj": (cond_proj, (n_layers, b, t, 2 * c)),
              "wd": (wd, (n_layers, 3, c, 2 * c)), "bd": (bd, (n_layers, 2 * c)),
              "wo": (wo, (n_layers, c, 2 * c)), "bo": (bo, (n_layers, 2 * c))}
    for name, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"residual_stack: {name} {tuple(a.shape)} != {shape}")
        if not a.is_contiguous():
            raise ValueError(f"residual_stack: {name} must be contiguous")
    if tuple(sb.shape) != (n_layers, b, c) or sb.stride(2) != 1:
        raise ValueError(f"residual_stack: sb {tuple(sb.shape)} must be "
                         f"[{n_layers},{b},{c}] with unit channel stride")
    for name, a in (("x0", x0), ("sb", sb), *((k, v[0]) for k, v in shapes.items())):
        if a.device != x0.device or a.dtype != x0.dtype:
            raise ValueError(f"residual_stack: {name} is {a.dtype} on "
                             f"{a.device}, expected {x0.dtype} on {x0.device}"
                             " (a state in another dtype than the operands "
                             "goes through diffnet_stack_train)")
    if not x0.is_contiguous():
        raise ValueError("residual_stack: x0 must be contiguous")


def residual_stack(x0, sb, cond_proj, wd, bd, wo, bo, *, cycle: int):
    """Run the full residual stack.

    :param x0:        [B, T, C] activations after input projection + relu
    :param sb:        [L, B, C] per-layer step bias (step MLP and each
                      layer's diffusion_projection); a batch stride of 0
                      (an expanded view) is accepted
    :param cond_proj: [L, B, T, 2C] hoisted conditioner projections
    :param wd/bd:     [L, 3, C, 2C] / [L, 2C] dilated-conv taps (t-d, t, t+d)
    :param wo/bo:     [L, C, 2C] / [L, 2C] output 1x1
    :returns:         [B, T, C] float32 skip sum (caller scales by 1/sqrt(L))

    All operands share x0's dtype (float32 or bfloat16) and device.  CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    """
    global launches
    _check(x0, sb, cond_proj, wd, bd, wo, bo)
    if x0.device.type == "cpu":
        return residual_stack_plain(x0, sb, cond_proj, wd, bd, wo, bo,
                                    cycle=cycle)
    if x0.device.type != "cuda":
        raise ValueError(f"residual_stack: unsupported device {x0.device}")
    b, t, c = x0.shape
    x = x0.clone()                                  # running state, in place
    h = torch.empty_like(x0)
    skip = torch.empty(b, t, c, dtype=torch.float32, device=x0.device)
    lib = _build.lib()
    err = lib.dsvc_residual_stack(
        _DTYPES[x0.dtype], x.data_ptr(), h.data_ptr(), skip.data_ptr(),
        sb.data_ptr(), sb.stride(0), sb.stride(1), cond_proj.data_ptr(),
        wd.data_ptr(), bd.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        b, t, c, cond_proj.shape[0], cycle, _build.stream())
    _build.check(err, "dsvc_residual_stack")
    launches += 1
    return skip
