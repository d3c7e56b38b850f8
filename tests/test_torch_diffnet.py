"""DiffNet and K1 (the residual stack) in the torch port against the JAX
package, on the CPU (the port's wrappers take their plain versions for CPU
tensors; the JAX stack kernel runs in Pallas interpret mode).

Weights flow the way the port loads real checkpoints: the torch module's
state dict goes through the JAX package's converter
(``convert_torch.convert_diffnet``), so both sides run identical weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsvc_tpu.models import diffnet as jdiffnet
from diffsvc_tpu.ops.pallas import diffnet_stack as jstack
from diffsvc_tpu.utils import convert_torch as cvt
from diffsvc_tpu_torch.models import diffnet
from diffsvc_tpu_torch.ops.hopper import diffnet_stack

M, H, C = 16, 24, 32


def _pair(layers=4, cycle=4, seed=0):
    torch.manual_seed(seed)
    net = diffnet.DiffNet(M, H, layers, C, cycle)
    with torch.no_grad():   # the reference zero-inits it; keep eps nonzero
        net.output_projection.weight.normal_(0, 0.2)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    jparams = cvt.convert_diffnet(sd, layers)
    jcfg = jdiffnet.DiffNetConfig(in_dims=M, encoder_hidden=H,
                                  residual_layers=layers, residual_channels=C,
                                  dilation_cycle_length=cycle,
                                  pallas_stack="off")
    return net, jparams, jcfg


def _inputs(b=2, t=40, seed=1):
    rng = np.random.RandomState(seed)
    spec = rng.randn(b, t, M).astype(np.float32)
    cond = (rng.randn(b, t, H) * 0.5).astype(np.float32)
    steps = rng.randint(0, 1000, size=b).astype(np.int32)
    return spec, cond, steps


@pytest.mark.parametrize("layers,cycle", [(4, 4), (6, 3)])
def test_apply_matches_jax_scan_f32(layers, cycle):
    """Tolerance 1e-5: the same f32 math, summed in another order."""
    net, jp, jcfg = _pair(layers, cycle)
    spec, cond, steps = _inputs()
    ref = jdiffnet.apply(jp, jcfg, jnp.asarray(spec), jnp.asarray(steps),
                         jnp.asarray(cond), inference=True)
    got = diffnet.apply(net, torch.from_numpy(spec), torch.from_numpy(steps),
                        torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_apply_matches_jax_scan_bf16():
    """bf16 operands: the port rounds where the TPU kernel rounds, the JAX
    scan rounds inside XLA's bf16 ops; tolerance 5e-2 (a few bf16 ulps of
    O(1) outputs after 4 layers)."""
    net, jp, jcfg = _pair()
    spec, cond, steps = _inputs()
    cast = lambda tr: jax.tree.map(  # noqa: E731
        lambda a: jnp.asarray(a).astype(jnp.bfloat16), tr)
    ref = jdiffnet.apply(cast(jp), jcfg, jnp.asarray(spec, jnp.bfloat16),
                         jnp.asarray(steps),
                         jnp.asarray(cond, jnp.bfloat16), inference=True)
    got = diffnet.apply(net, torch.from_numpy(spec).bfloat16(),
                        torch.from_numpy(steps),
                        torch.from_numpy(cond))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_residual_stack_plain_matches_pallas_interpret(dtype, tol):
    """K1's plain version vs the TPU kernel run in interpret mode, per
    sample (the TPU kernel is B=1).  f32: 1e-5 (summation order); bf16:
    2e-2, as tests/test_diffnet_stack.py allows the TPU kernel."""
    net, _, _ = _pair()
    p = net.stacked(dtype)
    rng = np.random.RandomState(3)
    b, t = 2, 48
    x0 = torch.from_numpy(np.abs(rng.randn(b, t, C)).astype(np.float32))
    sb = torch.from_numpy(rng.randn(4, b, C).astype(np.float32) * 0.3)
    cp = torch.from_numpy(rng.randn(4, b, t, 2 * C).astype(np.float32) * 0.3)
    x0, sb, cp = x0.to(dtype), sb.to(dtype), cp.to(dtype)
    got = diffnet_stack.residual_stack(x0, sb, cp, p["wd"], p["bd"], p["wo"],
                                       p["bo"], cycle=4)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def j(a):
        return jnp.asarray(a.float().numpy()).astype(jdt)

    for i in range(b):
        ref = jstack.residual_stack(j(x0[i]), j(sb[:, i]), j(cp[:, i]),
                                    j(p["wd"]), j(p["bd"]), j(p["wo"]),
                                    j(p["bo"]), cycle=4, interpret=True)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref),
                                   rtol=tol, atol=tol)


def test_residual_stack_checks_operands():
    net, _, _ = _pair()
    p = net.stacked(torch.float32)
    x0 = torch.zeros(1, 8, C)
    sb = torch.zeros(4, 1, C)
    cp = torch.zeros(4, 1, 8, 2 * C)
    with pytest.raises(ValueError):
        diffnet_stack.residual_stack(x0, sb, cp[:, :, :4], p["wd"], p["bd"],
                                     p["wo"], p["bo"], cycle=4)
    with pytest.raises(ValueError):
        diffnet_stack.residual_stack(x0, sb.bfloat16(), cp, p["wd"], p["bd"],
                                     p["wo"], p["bo"], cycle=4)
    # an expanded (batch-stride-0) step bias is accepted
    out = diffnet_stack.residual_stack(x0, sb[:, :1].expand(4, 1, C), cp,
                                       p["wd"], p["bd"], p["wo"], p["bo"],
                                       cycle=4)
    assert out.shape == (1, 8, C) and out.dtype == torch.float32


def test_stacked_cache_follows_weight_updates():
    net, _, _ = _pair()
    a = net.stacked(torch.float32)["wd"].clone()
    with torch.no_grad():
        net.residual_layers[0].dilated_conv.weight.add_(1.0)
    b = net.stacked(torch.float32)["wd"]
    assert not torch.equal(a, b)
