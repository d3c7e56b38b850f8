"""K6's tensor-core routes as far as the CPU can reach them.

At f32 the kernels (``csrc/diffnet_block.cu``, one layer of K1's 3xTF32
route) split every operand as a = hi + lo and sum a_lo b_hi + a_hi b_lo +
a_hi b_hi; here the plain version runs with those products
(``diffnet_stack.matmul_tf32x3``) against the JAX package's
``fused_residual_block`` in interpret mode at the f32 tolerance of
``tests/test_torch_block.py`` (1e-5), and single-pass TF32 must fail it.
Then the weight packing at a ragged C (K1's layout, one layer), the packed
weights kept per weight tensor and repacked after an in-place change, and
the kernel sources free of the SIMT layer kernels.  The kernels themselves
run in ``test_torch_cuda.py`` (``gpu``) and ``chip_smoke.py``.
"""

import gc
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsvc_tpu.ops.pallas.diffnet_block import (fused_residual_block as
                                                  jblock)
from diffsvc_tpu_torch.ops.hopper import diffnet_block as k6
from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds

from test_torch_block import _inputs
from test_torch_tc_plan import CSRC, _unpack_paired
from test_torch_tf32x3 import PRODUCTS, ROUTES

C, CP = 40, 64     # a ragged width: channels padded to one 64-wide tile


@pytest.mark.parametrize("route,within", ROUTES)
@pytest.mark.parametrize("dilation", [1, 8])
def test_emulated_block_matches_jax_interpret(dilation, route, within):
    """x' and skip at B=2, T=256, C=128 with the kernels' products."""
    a = _inputs(2, 256, 128)
    want = jblock(*map(jnp.asarray, a), dilation=dilation, interpret=True)
    got = k6.fused_residual_block_plain(
        *map(torch.from_numpy, a), dilation=dilation,
        matmul=PRODUCTS[route])
    ok = [np.allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
          for g, w in zip(got, want)]
    assert all(ok) == within


def _weights(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return ((torch.randn(3, C, 2 * C, generator=g) / 10).to(dtype),
            (torch.randn(C, 2 * C, generator=g) / 10).to(dtype))


def test_pack_weights_ragged_bf16():
    """One layer in K1's paired K-major layout, exact, padding +0."""
    assert ds.tc_plan(1, 77, C).cp == CP
    w_dil, w_out = _weights(torch.bfloat16)
    wd, wo = k6.pack_weights(w_dil, w_out, CP)
    assert wd.shape == (2 * CP, 3 * CP) and wo.shape == (2 * CP, CP)
    assert torch.equal(_unpack_paired(wd[None], C, 3)[0], w_dil)
    assert torch.equal(_unpack_paired(wo[None], C, 1)[0, 0], w_out)
    for p, w in ((wd, w_dil), (wo, w_out[None])):
        real = ds.pack_paired(torch.ones_like(w)[None], CP)[0] != 0
        assert not p.view(torch.int16)[~real].any()


def test_pack_weights_ragged_f32():
    """At f32 a hi and a lo plane: exact TF32 values whose sum is within
    2^-22 of each weight, padding +0 in both."""
    assert ds.tc_plan(1, 77, C, dtype=torch.float32).cp == CP
    w_dil, w_out = _weights(torch.float32)
    wd, wo = k6.pack_weights(w_dil, w_out, CP)
    assert wd.shape == (2, 2 * CP, 3 * CP) and wo.shape == (2, 2 * CP, CP)
    for p, w, taps in ((wd, w_dil, 3), (wo, w_out[None], 1)):
        assert not (p.view(torch.int32) & 0x1FFF).any()
        hi, lo = _unpack_paired(p, C, taps).double()
        err = (hi + lo - w.double()).abs()
        assert (err <= 2.0 ** -22 * w.double().abs()).all()
        real = ds.pack_paired(torch.ones_like(w)[None], CP)[0] != 0
        assert not p.view(torch.int32)[:, ~real].any()


def test_packed_weights_repack_after_an_in_place_change():
    """The packed copy is kept per weight tensor; a change in place (also
    through a view's base) or another tensor packs anew; the entry dies
    with its weight."""
    stack = torch.randn(2, 3, C, 2 * C) / 10
    w_dil, w_out = stack[0], torch.randn(C, 2 * C) / 10
    first = k6.packed_weights(w_dil, w_out, CP)
    assert k6.packed_weights(w_dil, w_out, CP)[0] is first[0]
    for change in (lambda: w_out.mul_(2), lambda: stack.add_(1)):
        change()
        got = k6.packed_weights(w_dil, w_out, CP)
        assert got[0] is not first[0]
        for g, want in zip(got, k6.pack_weights(w_dil, w_out, CP)):
            assert torch.equal(g, want)
        first = got
    other = w_dil.clone()
    assert k6.packed_weights(other, w_out, CP)[0] is not first[0]
    n = len(k6._packed)
    del other
    gc.collect()
    assert len(k6._packed) == n - 1


def test_no_simt_layer_kernel_source():
    """The SIMT layer kernels are gone: no ``block_out_kernel`` and no
    ``gate_kernel`` but the 3xTF32 one, and K6 builds on K1's headers."""
    srcs = {}
    for fn in os.listdir(CSRC):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn)) as f:
                srcs[fn] = f.read()
    assert "diffnet_layer.cuh" not in srcs
    defs = {fn for fn, s in srcs.items()
            if re.search(r"\bgate_kernel\s*\(", s)}
    assert defs == {"diffnet_layer_tf32x3.cuh"}
    assert not any("block_out_kernel" in s for s in srcs.values())
    assert '#include "diffnet_layer_tf32x3.cuh"' in srcs["diffnet_block.cu"]
