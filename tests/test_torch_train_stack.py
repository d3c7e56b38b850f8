"""K4 (the training residual stack) and DiffNet's training route in the torch
port against the JAX package, on the CPU.

The port's wrappers take their plain versions for CPU tensors; the JAX side
runs ``residual_stack_train_batched`` (its custom VJP around the Pallas
forward-with-save and batch-fused backward) in interpret mode.  Both round
at the same points, so the tolerances are those of
``tests/test_diffnet_stack_train.py`` for the same streams: f32 values
2e-5 and grads 2e-5 of the largest entry; bf16 values 2e-2 and grads 6e-3.
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
from diffsvc_tpu_torch.ops.hopper import diffnet_stack, diffnet_stack_train as k4
from diffsvc_tpu_torch.utils.convert import diffusion_jax_to_torch

L, CYC, T, C = 4, 2, 128, 128
NAMES = ["dx0", "dsb", "dcp", "dwd", "dbd", "dwo", "dbo"]


def _stack_args(b, seed=0):
    rng = np.random.RandomState(seed)
    a = [rng.randn(b, T, C) * 0.3, rng.randn(L, b, C) * 0.2,
         rng.randn(L, b, T, 2 * C) * 0.2, rng.randn(L, 3, C, 2 * C) * 0.05,
         rng.randn(L, 2 * C) * 0.1, rng.randn(L, C, 2 * C) * 0.05,
         rng.randn(L, 2 * C) * 0.1]
    return [x.astype(np.float32) for x in a], \
        rng.randn(b, T, C).astype(np.float32)


def _relmax(got, want):
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


@pytest.mark.parametrize("b", [3, 1])
@pytest.mark.parametrize("sd,tol_val,tol_grad", [("f32", 2e-5, 2e-5),
                                                 ("bf16", 2e-2, 6e-3)])
def test_plain_matches_jax_interpret(b, sd, tol_val, tol_grad):
    """Forward value and all seven cotangents of K4's plain versions (through
    ResidualStackTrainFn) against the Pallas kernels in interpret mode."""
    a, tgt = _stack_args(b)

    def loss_j(*aa):
        out = jstack.residual_stack_train_batched(*aa, CYC, True, sd)
        return jnp.sum((out - tgt) ** 2), out

    (lj, oj), gj = jax.value_and_grad(loss_j, argnums=tuple(range(7)),
                                      has_aux=True)(*map(jnp.asarray, a))
    ta = [torch.from_numpy(x).requires_grad_() for x in a]
    out = k4.residual_stack_train_batched(*ta, cycle=CYC, stream=sd)
    lt = ((out - torch.from_numpy(tgt)) ** 2).sum()
    lt.backward()
    oj = np.asarray(oj)
    np.testing.assert_allclose(out.detach().numpy(), oj, rtol=tol_val,
                               atol=tol_val * np.abs(oj).max())
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=tol_val)
    for n, x, y in zip(NAMES, ta, gj):
        assert x.grad.dtype == torch.float32, n  # the primal's dtype
        assert _relmax(x.grad.numpy(), np.asarray(y)) < tol_grad, n


def test_plain_backward_matches_autograd_f32():
    """With f32 streams no rounding intervenes, so the explicit backward
    must equal torch autograd of the plain forward (an independent check of
    its algebra): 1e-5 of each grad's largest entry."""
    a, tgt = _stack_args(2, seed=1)
    ta = [torch.from_numpy(x).requires_grad_() for x in a]
    skip, _ = k4.residual_stack_train_fwd_plain(*ta, cycle=CYC)
    dout = 2 * (skip - torch.from_numpy(tgt))
    auto = torch.autograd.grad((dout.detach() * skip).sum(), ta)
    with torch.no_grad():
        _, xsave = k4.residual_stack_train_fwd_plain(*ta, cycle=CYC)
        got = k4.residual_stack_train_batched_bwd_plain(
            xsave, ta[1], ta[2], ta[3], ta[4], ta[5], dout.detach(),
            cycle=CYC)
    for n, x, y in zip(NAMES, got, auto):
        assert _relmax(x.numpy(), y.numpy()) < 1e-5, n


def test_no_grad_route_matches_jax_primal():
    """Without grad (validation's loss) the route is K1, as the JAX primal
    runs it: f32 activations, cond_proj / wd / wo rounded to bf16."""
    a, _ = _stack_args(2)
    ta = list(map(torch.from_numpy, a))
    with torch.no_grad():
        got = k4.residual_stack_train_batched(*ta, cycle=CYC, stream="bf16")
    for i in (2, 3, 5):
        ta[i] = ta[i].bfloat16().float()
    assert torch.equal(got, diffnet_stack.residual_stack(*ta, cycle=CYC))
    want = np.asarray(jstack.residual_stack_train_batched(
        *map(jnp.asarray, a), CYC, True, "bf16"))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())


def test_mixed_dtypes_take_the_train_forward():
    """K1 keeps one dtype for the state and the operands (it raises on a
    mix); an f32 state with bf16 operands goes through K4's forward, which
    rounds y and h to bf16 and keeps x in f32."""
    a, _ = _stack_args(1)
    x0, sb, cp, wd, bd, wo, bo = map(torch.from_numpy, a)
    bf = [t.bfloat16() for t in (cp, wd, wo)]
    with pytest.raises(ValueError, match="diffnet_stack_train"):
        diffnet_stack.residual_stack(x0, sb, bf[0], bf[1], bd, bf[2], bo,
                                     cycle=CYC)
    skip, xsave = k4.residual_stack_train_fwd(x0, sb, bf[0], bf[1], bd,
                                              bf[2], bo, cycle=CYC)
    assert skip.dtype == torch.float32 and xsave.dtype == torch.bfloat16
    assert torch.equal(xsave[0], x0.bfloat16())
    with pytest.raises(TypeError):
        k4.residual_stack_train_fwd(x0.bfloat16(), sb, cp, wd, bd, wo, bo,
                                    cycle=CYC)


def _pair():
    torch.manual_seed(0)
    net = diffnet.DiffNet(16, 32, L, C, CYC)
    with torch.no_grad():   # a zero head would zero every inner gradient
        net.output_projection.weight.normal_(0, 0.2)
    jparams = cvt.convert_diffnet({k: v.numpy() for k, v in
                                   net.state_dict().items()}, L)
    return net, jax.tree.map(jnp.asarray, jparams)


def _apply_inputs():
    rng = np.random.RandomState(0)
    return (rng.randn(2, T, 16).astype(np.float32), np.array([3, 7], np.int32),
            (rng.randn(2, T, 32) * 0.3).astype(np.float32),
            rng.randn(2, T, 16).astype(np.float32))


@pytest.mark.parametrize("sd,tol_loss,tol_grad", [("f32", 1e-5, 1e-3),
                                                  ("bf16", 5e-3, 3e-2)])
def test_apply_training_grads_match_jax(sd, tol_loss, tol_grad):
    """diffnet.apply's training route (K4 through ResidualStackTrainFn,
    weights stacked with grad) against JAX apply with ``pallas_train='interpret'``:
    the loss and every parameter's gradient, including the conditioner and
    step-MLP paths that flow through dcp and dsb.  Tolerances of
    tests/test_diffnet_stack_train.py:95-122 (f32) and :272-293 (bf16)."""
    net, jp = _pair()
    cfg = jdiffnet.DiffNetConfig(in_dims=16, encoder_hidden=32,
                                 residual_layers=L, residual_channels=C,
                                 dilation_cycle_length=CYC,
                                 pallas_train="interpret", train_stream=sd)
    spec, steps, cond, tgt = _apply_inputs()

    def loss_j(p):
        out = jdiffnet.apply(p, cfg, jnp.asarray(spec), jnp.asarray(steps),
                             jnp.asarray(cond))
        return jnp.mean((out - tgt) ** 2)

    lj, gj = jax.value_and_grad(loss_j)(jp)
    out = diffnet.apply(net, torch.from_numpy(spec), torch.from_numpy(steps),
                        torch.from_numpy(cond), train_stream=sd)
    lt = ((out - torch.from_numpy(tgt)) ** 2).mean()
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=tol_loss)
    want = diffusion_jax_to_torch(
        {"fs2": {"mel_out": {"w": np.zeros((1, 1))}},
         "denoise_fn": jax.tree.map(np.asarray, gj)})
    for name, p in net.named_parameters():
        ref = want[f"denoise_fn.{name}"].numpy()
        assert p.grad is not None, name
        assert _relmax(p.grad.numpy(), ref) < tol_grad, name


def test_training_route_reaches_every_parameter():
    """Repair: the serving weights are cached and detached, so a loss built
    on them gave no parameter a gradient.  The training route must give
    every denoiser parameter a nonzero one."""
    net, _ = _pair()
    spec, steps, cond, tgt = _apply_inputs()
    out = diffnet.apply(net, torch.from_numpy(spec), torch.from_numpy(steps),
                        torch.from_numpy(cond), train_stream="bf16")
    ((out - torch.from_numpy(tgt)) ** 2).mean().backward()
    for name, p in net.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
    served = diffnet.apply(net, torch.from_numpy(spec),
                           torch.from_numpy(steps), torch.from_numpy(cond))
    assert not served.requires_grad


def test_init_follows_jax():
    """Repair: DiffNet's init is the JAX package's (kaiming-normal convs,
    zero output head), not torch's default (uniform, nonzero head)."""
    torch.manual_seed(0)
    net = diffnet.DiffNet(16, 32, 4, 64, 2)
    assert float(net.output_projection.weight.abs().max()) == 0.0
    assert float(net.output_projection.bias.abs().max()) == 0.0
    w = net.residual_layers[0].dilated_conv.weight        # [2C, C, 3]
    assert abs(float(w.std()) / np.sqrt(2.0 / (64 * 3)) - 1.0) < 0.05
    # kaiming-normal is unbounded; torch's default is uniform within 1/sqrt(fan_in)
    assert float(w.abs().max()) > 1.0 / np.sqrt(64 * 3)
    jp = jdiffnet.init(jax.random.PRNGKey(0), jdiffnet.DiffNetConfig(
        in_dims=16, encoder_hidden=32, residual_layers=4,
        residual_channels=64, dilation_cycle_length=2))
    jw = np.asarray(jp["layers"]["dilated_conv"]["w"])
    assert abs(float(w.std()) / float(jw.std()) - 1.0) < 0.05
