"""K5 (the per-sample training route) and the training route rule of the
torch port against the JAX package, on the CPU.

The port's wrappers take their plain versions for CPU tensors; the JAX side
runs ``jax.vmap`` of ``residual_stack_train`` (its custom VJP around the
Pallas forward-with-save and per-sample backward) in interpret mode.  Both
round at the same points with f32 streams, so the tolerance is the f32 one
of ``tests/test_torch_train_stack.py``: values and grads 2e-5 of the
largest entry.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsvc_tpu.models import diffnet as jdiffnet
from diffsvc_tpu.ops.pallas import diffnet_stack as jstack
from diffsvc_tpu_torch.models import diffnet
from diffsvc_tpu_torch.ops.hopper import diffnet_stack_per_sample as k5
from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4
from diffsvc_tpu_torch.utils.convert import diffusion_jax_to_torch
from test_torch_train_stack import (CYC, NAMES, _apply_inputs, _pair,
                                    _relmax, _stack_args)


def _jax_per_sample(*a):
    """The JAX route of diffsvc_tpu/models/diffnet.py:269-274."""
    x0, sb, cp, wd, bd, wo, bo = a
    return jax.vmap(lambda x1, sb1, cp1: jstack.residual_stack_train(
        x1, sb1, cp1, wd, bd, wo, bo, CYC, True),
        in_axes=(0, 1, 1))(x0, sb, cp)


@pytest.mark.parametrize("b", [1, 3])
def test_plain_matches_jax_vmapped_interpret(b):
    """Forward value and all seven cotangents of K5's plain version
    (through ResidualStackTrainFn) at L=4, cycle 2, T=C=128."""
    a, tgt = _stack_args(b)

    def loss_j(*aa):
        out = _jax_per_sample(*aa)
        return jnp.sum((out - tgt) ** 2), out

    (lj, oj), gj = jax.value_and_grad(loss_j, argnums=tuple(range(7)),
                                      has_aux=True)(*map(jnp.asarray, a))
    ta = [torch.from_numpy(x).requires_grad_() for x in a]
    out = k5.residual_stack_train(*ta, cycle=CYC)
    lt = ((out - torch.from_numpy(tgt)) ** 2).sum()
    lt.backward()
    oj = np.asarray(oj)
    np.testing.assert_allclose(out.detach().numpy(), oj, rtol=2e-5,
                               atol=2e-5 * np.abs(oj).max())
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=2e-5)
    for n, x, y in zip(NAMES, ta, gj):
        assert x.grad.dtype == torch.float32, n
        assert _relmax(x.grad.numpy(), np.asarray(y)) < 2e-5, n


def test_batch_is_the_in_order_sum_of_its_samples():
    """The plain backward at B=3 gives each sample's dx0 / dsb / dcp as its
    own B=1 run does, and weight and bias grads equal to the in-order sum of
    the B=1 runs, bit for bit; at an f32 stream it agrees with K4's
    batch-summed backward to 1e-5 of the largest entry (the order of the
    sums is the only difference)."""
    a, dout = _stack_args(3, seed=4)
    ta = list(map(torch.from_numpy, a))
    _, xsave = k4.residual_stack_train_fwd_plain(*ta, cycle=CYC)
    ops = (ta[1], ta[2], ta[3], ta[4], ta[5])
    dout = torch.from_numpy(dout)
    got = k5.residual_stack_train_bwd(xsave, *ops, dout, cycle=CYC)
    ones = [k5.residual_stack_train_bwd(
        xsave[:, i:i + 1].contiguous(), ta[1][:, i:i + 1],
        ta[2][:, i:i + 1].contiguous(), *ta[3:6], dout[i:i + 1],
        cycle=CYC) for i in range(3)]
    assert torch.equal(got[0], torch.cat([o[0] for o in ones]))
    for k in (1, 2):
        assert torch.equal(got[k], torch.cat([o[k] for o in ones], dim=1))
    for k in range(3, 7):
        tot = torch.zeros_like(got[k])
        for o in ones:
            tot = tot + o[k]
        assert torch.equal(got[k], tot), NAMES[k]
    ref = k4.residual_stack_train_batched_bwd(xsave, *ops, dout, cycle=CYC)
    for n, x, y in zip(NAMES, got, ref):
        assert _relmax(x.numpy(), y.numpy()) < 1e-5, n


def test_rejects_a_stream_cotangent():
    """K5 takes the f32 cotangent (``_rst_bwd`` casts it), not the stream's."""
    a, dout = _stack_args(1)
    ta = list(map(torch.from_numpy, a))
    cp, wd, wo = (t.bfloat16() for t in (ta[2], ta[3], ta[5]))
    _, xsave = k4.residual_stack_train_fwd(ta[0].bfloat16(), ta[1], cp, wd,
                                           ta[4], wo, ta[6], cycle=CYC)
    with pytest.raises(ValueError, match="dout"):
        k5.residual_stack_train_bwd(xsave, ta[1], cp, wd, ta[4], wo,
                                    torch.from_numpy(dout).bfloat16(),
                                    cycle=CYC)


def _jax_route(n_layers, cycle, t, c, b, stream):
    esz = 2 if stream == "bf16" else 4
    if jstack.supported_train_batched(n_layers, cycle, t, c, b,
                                      stream_esize=esz):
        return "batched"
    if jstack.supported_train(n_layers, cycle, t, c):
        return "per_sample"
    return "scan"


@pytest.mark.parametrize("stream", ["bf16", "f32"])
@pytest.mark.parametrize("c", [100, 128, 256, 384])
def test_train_route_matches_jax_gates(c, stream):
    """Every batch of 1-96 and T of 128-2560 (every multiple of 64), for
    config_44k's 20 layers in cycles of 4 and a few other layer counts."""
    assert jstack.PALLAS_OK
    layer_sets = [(20, 4), (4, 2), (6, 4), (16, 8)]
    for (n, cyc), t, b in itertools.product(layer_sets, range(128, 2561, 64),
                                            range(1, 97)):
        want = _jax_route(n, cyc, t, c, b, stream)
        assert diffnet.train_route(n, cyc, t, c, b, stream) == want, \
            (n, cyc, t, c, b, stream)


@pytest.mark.parametrize("stream,t,largest", [
    ("bf16", 512, 59), ("bf16", 640, 46), ("bf16", 1024, 25),
    ("bf16", 1152, 22), ("bf16", 1408, 16), ("bf16", 2304, 7),
    ("f32", 512, 47), ("f32", 640, 35), ("f32", 1024, 16),
    ("f32", 1152, 13), ("f32", 1408, 8), ("f32", 2304, 0)])
def test_config_44k_routes(stream, t, largest):
    """The production rows: at C=384 the largest batch K4 takes; larger
    batches go per-sample up to T=2304, and T=2432 takes the scan.  A
    batch of 88 (config_44k's max_sentences) at 4-15 s clips goes to K5."""
    route = lambda b, tt=t: diffnet.train_route(20, 4, tt, 384, b, stream)
    if largest:
        assert route(largest) == "batched"
    assert route(largest + 1) == "per_sample" == route(88)
    assert route(88, 2432) == "scan"
    assert diffnet.train_route(20, 4, 1024, 256, 47, "bf16") == "batched"
    assert diffnet.train_route(20, 4, 1024, 256, 48, "bf16") == "per_sample"


@pytest.mark.parametrize("sd", ["f32", "bf16"])
def test_apply_per_sample_route_matches_jax(monkeypatch, sd):
    """diffnet.apply on the per-sample route against JAX apply with
    ``pallas_train='interpret'`` and ``supported_train_batched`` patched to
    False: the loss and every parameter's gradient.  The route streams f32
    whatever the configured stream, so both get the f32 tolerances of
    tests/test_torch_train_stack.py (loss 1e-5, grads 1e-3)."""
    net, jp = _pair()
    cfg = jdiffnet.DiffNetConfig(in_dims=16, encoder_hidden=32,
                                 residual_layers=4, residual_channels=128,
                                 dilation_cycle_length=CYC,
                                 pallas_train="interpret", train_stream=sd)
    spec, steps, cond, tgt = _apply_inputs()
    monkeypatch.setattr(jstack, "supported_train_batched",
                        lambda *a, **k: False)
    calls = []

    def bwd(*a, **k):
        calls.append(a[0].shape)
        return real_bwd(*a, **k)

    real_bwd = k5.residual_stack_train_bwd
    monkeypatch.setattr(k5, "residual_stack_train_bwd", bwd)
    routes = []
    real_route = diffnet.train_route

    def route(*a):
        routes.append(real_route(*a))
        return "per_sample"

    monkeypatch.setattr(diffnet, "train_route", route)

    def loss_j(p):
        out = jdiffnet.apply(p, cfg, jnp.asarray(spec), jnp.asarray(steps),
                             jnp.asarray(cond))
        return jnp.mean((out - tgt) ** 2)

    lj, gj = jax.value_and_grad(loss_j)(jp)
    out = diffnet.apply(net, torch.from_numpy(spec), torch.from_numpy(steps),
                        torch.from_numpy(cond), train_stream=sd)
    lt = ((out - torch.from_numpy(tgt)) ** 2).mean()
    lt.backward()
    assert routes == ["batched"] and len(calls) == 1
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    want = diffusion_jax_to_torch(
        {"fs2": {"mel_out": {"w": np.zeros((1, 1))}},
         "denoise_fn": jax.tree.map(np.asarray, gj)})
    for name, p in net.named_parameters():
        ref = want[f"denoise_fn.{name}"].numpy()
        assert _relmax(p.grad.numpy(), ref) < 1e-3, name


def test_no_grad_per_sample_route_is_the_f32_primal():
    """Validation's loss on the per-sample route: K1 at the state's own
    dtype, as the JAX primal of ``residual_stack_train`` runs it."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack

    a, _ = _stack_args(2)
    ta = list(map(torch.from_numpy, a))
    with torch.no_grad():
        got = k5.residual_stack_train(*ta, cycle=CYC)
    assert torch.equal(got, diffnet_stack.residual_stack(*ta, cycle=CYC))
    want = np.asarray(_jax_per_sample(*map(jnp.asarray, a)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())
