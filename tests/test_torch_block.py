"""K6 (the single residual block) in the torch port against the JAX
package's ``fused_residual_block``, on the CPU.

The port's wrapper takes its plain version for CPU tensors; the JAX side
runs the Pallas kernel in interpret mode.  f32 at the tolerance of
``tests/test_pallas.py`` (1e-5).  bf16: the same roundings on both sides;
an f32 product summed in another order can still flip one rounding to
bf16, so each output is held to 2^-8 of its largest entry (one bf16 step;
x' read equal and skip 4.4e-4 at d=8, the taps read at 2d 0.31 and 0.81).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsvc_tpu.ops.pallas.diffnet_block import (fused_residual_block as
                                                  jblock, reference_block)
from diffsvc_tpu_torch.ops.hopper import diffnet_block as k6


def _inputs(b, t, c, seed=0, scale=0.3):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, t, c) * scale).astype(np.float32),
            (rng.randn(b, c) * scale).astype(np.float32),
            (rng.randn(b, t, 2 * c) * scale).astype(np.float32),
            (rng.randn(3, c, 2 * c) * 0.05).astype(np.float32),
            (rng.randn(2 * c) * 0.05).astype(np.float32),
            (rng.randn(c, 2 * c) * 0.05).astype(np.float32),
            (rng.randn(2 * c) * 0.05).astype(np.float32)]


def _port(a, dilation, dtype=torch.float32):
    out = k6.fused_residual_block(*(torch.from_numpy(x).to(dtype) for x in a),
                                  dilation=dilation)
    return [o.float().numpy() for o in out]


@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
def test_plain_matches_jax_interpret(dilation):
    """x' and skip at B=2, T=256, C=128 against the Pallas kernel."""
    a = _inputs(2, 256, 128)
    want = jblock(*map(jnp.asarray, a), dilation=dilation, interpret=True)
    for got, ref in zip(_port(a, dilation), want):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_tile_boundary_rows():
    """Taps at d=8 that cross the TPU kernel's 128-row tile: rows 120:136."""
    a = _inputs(1, 256, 128, seed=1, scale=1.0)
    for i in (1, 2, 4, 6):
        a[i] = np.zeros_like(a[i])
    want = jblock(*map(jnp.asarray, a), dilation=8, interpret=True,
                  tile_t=128)
    got = _port(a, 8)
    np.testing.assert_allclose(got[0][0, 120:136],
                               np.asarray(want[0])[0, 120:136],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dilation", [1, 8])
def test_bf16_matches_jax_interpret(dilation):
    """Every operand in bf16 on both sides: the rounding points of the TPU
    kernel (y, h, o[:, :C] and the residual add rounded to bf16; skip
    returned in bf16); tolerance in the module docstring."""
    a = _inputs(2, 256, 128, seed=2)
    bf = [jnp.asarray(x).astype(jnp.bfloat16) for x in a]
    want = jblock(*bf, dilation=dilation, interpret=True)
    got = _port(a, dilation, torch.bfloat16)
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert np.abs(g - w).max() <= np.abs(w).max() / 256


@pytest.mark.parametrize("t,dilation", [(77, 4), (5, 8)])
def test_any_t_against_reference(t, dilation):
    """No ``T % tile`` condition: ragged T and a dilation beyond T (every
    tap outside [0, T) reads zero) against the plain-JAX reference."""
    a = _inputs(2, t, 128, seed=3)
    want = reference_block(*map(jnp.asarray, a), dilation)
    for got, ref in zip(_port(a, dilation), want):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_rejects_mixed_dtypes_and_shapes():
    a = [torch.from_numpy(x) for x in _inputs(1, 16, 8)]
    with pytest.raises(ValueError, match="step"):
        k6.fused_residual_block(a[0], a[1].bfloat16(), *a[2:], dilation=1)
    with pytest.raises(ValueError, match="w_out"):
        k6.fused_residual_block(*a[:5], a[5][:, :8].contiguous(), a[6],
                                dilation=1)
