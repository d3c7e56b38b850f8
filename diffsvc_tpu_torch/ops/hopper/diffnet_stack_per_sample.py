"""K5: the DiffNet residual stack's per-sample training route — hand-written
Hopper kernel (the backward) + its plain PyTorch version.

Replaces ``diffsvc_tpu/ops/pallas/diffnet_stack.py:residual_stack_train``
(custom VJP ``_rst_fwd``/``_rst_bwd``, backward ``_bwd_kernel`` via
``_call_bwd``) as ``diffsvc_tpu/models/diffnet.py:269-274`` vmaps it over
a batch: the route of batches whose [B, T, C] dx carry does not fit K4's
batch-fused backward (``models/diffnet.py:train_route``).  CUDA source:
``csrc/diffnet_stack_per_sample.cu`` (+ the backward of
``csrc/diffnet_train_bwd.cuh``, shared with K4).  The forward with save is
K4's (``diffnet_stack_train.residual_stack_train_fwd``) at the state's own
dtype, as ``_call_fwd`` serves both JAX routes.

- Streams in the state's dtype (f32 in training): cond_proj, wd and wo are
  cast to x0's dtype, as the JAX route hands them over; the skip cotangent
  arrives in f32 (``_rst_bwd`` casts it); dcp comes back in f32, unrounded.
- Backward per sample (``_bwd_kernel``): y and h recomputed from the saved
  x_l and rounded to its dtype, do and dz rounded to it only as product
  operands, the dx carry within the sample, dx0 written once.
- vmap's transpose sums the per-sample weight and bias grads over the
  batch: each sample's grads are contracted over its own T rows and the
  samples' sums added in sample order, one launch per stage for the whole
  batch, without holding [B, L, 3, C, 2C] per-sample grads.  So a batch of
  B gives, bit for bit, the in-order sum of its B = 1 runs.

At an f32 stream this is K4's math; only the order of the weight- and
bias-grad sums differs.  What bounds it on the H100: tensor-core operations
(44 C^2 per row and layer for the backward, 60 C^2 with the forward; 5.8
TFLOP at B=32, T=1024, C=384, L=20): the f32 products run as 3xTF32 split
products on wgmma, K4's backward kernels with one weight-grad segment per
sample (``diffnet_stack_train.train_plan`` with ``seg_rows = T``).
"""

from __future__ import annotations

import torch

from . import _build
from .diffnet_stack import _DTYPES
from .diffnet_stack_train import (CCH, RCH, bwd_outputs, bwd_plain,
                                  bwd_scratch, check_bwd, on_card, pack_bwd,
                                  train_plan, train_stack)

launches = 0   # kernel launches (backward calls on CUDA tensors)


def residual_stack_train_bwd_plain(xsave, sb, cond_proj, wd, bd, wo, dout, *,
                                   cycle: int, matmul=torch.matmul):
    """Plain version: ``_bwd_kernel``'s math one sample at a time (dcp in
    f32), the samples' weight and bias grads added in sample order.  Same
    operands and results as :func:`residual_stack_train_bwd`; ``matmul``
    computes the products (:func:`~.diffnet_stack_train.bwd_plain`)."""
    per = [bwd_plain(xsave[:, i:i + 1], sb[:, i:i + 1], cond_proj[:, i:i + 1],
                     wd, bd, wo, dout[i:i + 1], cycle=cycle,
                     dcp_dtype=torch.float32, matmul=matmul)
           for i in range(xsave.shape[1])]
    dx0 = torch.cat([g[0] for g in per])
    dsb = torch.cat([g[1] for g in per], dim=1)
    dcp = torch.cat([g[2] for g in per], dim=1)
    sums = []
    for k in range(3, 7):
        tot = torch.zeros_like(per[0][k])
        for g in per:
            tot = tot + g[k]
        sums.append(tot)
    return (dx0, dsb, dcp, *sums)


def residual_stack_train_bwd(xsave, sb, cond_proj, wd, bd, wo, dout, *,
                             cycle: int):
    """Per-sample backward of the batch: (dx0 [B,T,C], dsb [L,B,C], dcp
    [L,B,T,2C], dwd, dbd, dwo, dbo summed over the batch in sample order),
    all f32.

    :param xsave: [L, B, T, C] saved layer inputs in the stream dtype (the
        state's: f32 or bf16); ``cond_proj`` [L,B,T,2C], ``wd`` [L,3,C,2C]
        and ``wo`` [L,C,2C] in the same dtype, contiguous
    :param sb: [L, B, C] step bias; ``bd`` [L, 2C] (any float dtype)
    :param dout: [B, T, C] f32 skip cotangent, contiguous
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global launches
    n_layers, b, t, c = xsave.shape
    check_bwd(xsave, sb, cond_proj, wd, bd, wo, dout, torch.float32,
              "residual_stack_train_bwd")
    if not on_card(xsave, "residual_stack_train_bwd"):
        return residual_stack_train_bwd_plain(xsave, sb, cond_proj, wd, bd,
                                              wo, dout, cycle=cycle)
    sd = wd.dtype
    plan = train_plan(b, t, c, t, sd)
    out = bwd_outputs(n_layers, b, t, c, torch.float32, xsave.device)
    scratch = bwd_scratch(b, t, c, t, plan, sd, xsave.device)
    gsum = torch.empty(b, 2 * c, dtype=torch.float32, device=xsave.device)
    sbf, bdf = sb.float().contiguous(), bd.float().contiguous()
    packed = pack_bwd(wd, wo, plan.cp)
    err = _build.lib().dsvc_stack_train_bwd_per_sample(
        _DTYPES[sd], xsave.data_ptr(), sbf.data_ptr(), cond_proj.data_ptr(),
        *(w.data_ptr() for w in packed), bdf.data_ptr(), dout.data_ptr(),
        *(a.data_ptr() for a in out), *(a.data_ptr() for a in scratch),
        gsum.data_ptr(), b, t, c, n_layers, cycle, RCH, CCH, plan.c_array(),
        _build.stream())
    _build.check(err, "dsvc_stack_train_bwd_per_sample")
    launches += 1
    return out


def residual_stack_train(x0, sb, cond_proj, wd, bd, wo, bo, *, cycle: int):
    """The per-sample training route of the residual stack: [B,T,C] f32
    skip sum, streamed in the state's own dtype; the backward is
    :func:`residual_stack_train_bwd` with the cotangent in f32
    (:func:`~.diffnet_stack_train.train_stack`)."""
    return train_stack((x0, sb, cond_proj, wd, bd, wo, bo), cycle=cycle,
                       sd=x0.dtype, bwd=residual_stack_train_bwd,
                       dout_dtype=torch.float32)
