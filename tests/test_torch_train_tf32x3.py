"""The arithmetic of the training stack's f32 route (K4 at the f32 stream,
and K5) on the CPU: 3xTF32 products held against the JAX package's f32.

The training kernels (``csrc/diffnet_train_bwd.cuh``, and K1's f32 layer
kernels for the forward) split every f32 operand as a = hi + lo and sum
a_lo b_hi + a_hi b_lo + a_hi b_hi on the tensor cores.  Here the plain
versions run with each product replaced by those three
(``diffnet_stack.matmul_tf32x3``) and must stay within the limits the
parity tests already hold the true-f32 port to: the Pallas kernels of
``residual_stack_train_batched`` and of ``jax.vmap`` over
``residual_stack_train`` in interpret mode at 2e-5 of each output's
largest entry (``test_torch_train_stack.py``,
``test_torch_train_per_sample.py``), and the true-f32 plain versions at the
kernel checks' rel-L2 limit of 1e-5 (``chip_smoke.py``).  The same runs
with single-pass TF32 products (a_hi b_hi alone) must exceed those limits.
The weight grads are also emulated through the kernels' own layout: rows
placed at their chunk positions in transposed planes, each chunk a product
of its own, the chunks summed in order; K5's batch must still equal the
in-order sum of its B=1 runs bit for bit.  The kernels themselves run in
``test_torch_cuda.py`` (``gpu``) and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsvc_tpu.ops.pallas import diffnet_stack as jstack
from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
from diffsvc_tpu_torch.ops.hopper import diffnet_stack_per_sample as k5
from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4

from test_torch_train_per_sample import _jax_per_sample
from test_torch_train_stack import CYC, NAMES, _relmax, _stack_args


def _tf32(a, b):
    """Single-pass TF32 products: what a kernel without the lo terms
    computes."""
    return ds.split_tf32(a)[0] @ ds.split_tf32(b)[0]


PRODUCTS = {"tf32x3": ds.matmul_tf32x3, "tf32": _tf32}
# (products, whether they stay within the f32 limits)
ROUTES = [("tf32x3", True), ("tf32", False)]


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _emulated(monkeypatch, route):
    """K4's and K5's wrappers on the CPU with their products in ``route``'s
    arithmetic (the autograd Function looks the wrappers up at call
    time)."""
    mm = PRODUCTS[route]
    fwd, bwd4 = (k4.residual_stack_train_fwd_plain,
                 k4.residual_stack_train_batched_bwd_plain)
    bwd5 = k5.residual_stack_train_bwd_plain
    monkeypatch.setattr(k4, "residual_stack_train_fwd",
                        lambda *a, **k: fwd(*a, matmul=mm, **k))
    monkeypatch.setattr(k4, "residual_stack_train_batched_bwd",
                        lambda *a, **k: bwd4(*a, matmul=mm, **k))
    monkeypatch.setattr(k5, "residual_stack_train_bwd",
                        lambda *a, **k: bwd5(*a, matmul=mm, **k))


def _against_jax(route_fn, jax_fn, b):
    """Forward value and all seven cotangents of ``route_fn`` (through
    ResidualStackTrainFn) against ``jax_fn``: the largest of their errors
    relative to each output's largest entry."""
    a, tgt = _stack_args(b)

    def loss_j(*aa):
        out = jax_fn(*aa)
        return jnp.sum((out - tgt) ** 2), out

    (_, oj), gj = jax.value_and_grad(loss_j, argnums=tuple(range(7)),
                                     has_aux=True)(*map(jnp.asarray, a))
    ta = [torch.from_numpy(x).requires_grad_() for x in a]
    out = route_fn(*ta)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    errs = {"skip": _relmax(out.detach().numpy(), np.asarray(oj))}
    errs.update({n: _relmax(x.grad.numpy(), np.asarray(y))
                 for n, x, y in zip(NAMES, ta, gj)})
    return errs


@pytest.mark.parametrize("route,within", ROUTES)
def test_emulated_k4_f32_matches_jax_interpret(monkeypatch, route, within):
    """K4 at the f32 stream, its products emulated, against the Pallas
    forward-with-save and batch-fused backward in interpret mode at B=3
    (L=4, cycle 2, T=C=128), at 2e-5."""
    _emulated(monkeypatch, route)
    errs = _against_jax(
        lambda *t: k4.residual_stack_train_batched(*t, cycle=CYC,
                                                   stream="f32"),
        lambda *a: jstack.residual_stack_train_batched(*a, CYC, True, "f32"),
        3)
    assert (max(errs.values()) < 2e-5) == within, errs


@pytest.mark.parametrize("route,within", ROUTES)
def test_emulated_k5_matches_jax_vmapped_interpret(monkeypatch, route,
                                                   within):
    """K5, its products emulated, against ``jax.vmap`` of the Pallas
    ``residual_stack_train`` in interpret mode at B=3, at 2e-5."""
    _emulated(monkeypatch, route)
    errs = _against_jax(lambda *t: k5.residual_stack_train(*t, cycle=CYC),
                        _jax_per_sample, 3)
    assert (max(errs.values()) < 2e-5) == within, errs


def _fwd_bwd(bwd, b, matmul, seed=2):
    """Skip sum and the seven grads of the forward with save and ``bwd``
    (K4's batch-fused or K5's per-sample plain backward) at B=b."""
    a, dout = _stack_args(b, seed=seed)
    ta = list(map(torch.from_numpy, a))
    skip, xsave = k4.residual_stack_train_fwd_plain(*ta, cycle=CYC,
                                                    matmul=matmul)
    grads = bwd(xsave, ta[1], ta[2], ta[3], ta[4], ta[5],
                torch.from_numpy(dout), cycle=CYC, matmul=matmul)
    return (skip, *grads)


@pytest.mark.parametrize("route,within", ROUTES)
@pytest.mark.parametrize("bwd", [k4.residual_stack_train_batched_bwd_plain,
                                 k5.residual_stack_train_bwd_plain],
                         ids=["k4", "k5"])
def test_emulated_matches_true_f32_plain(bwd, route, within):
    """The emulated forward and backward against the true-f32 plain
    versions at the kernel checks' limit: the largest rel-L2 over the skip
    sum and the seven grads <= 1e-5."""
    got = _fwd_bwd(bwd, 3, PRODUCTS[route])
    ref = _fwd_bwd(bwd, 3, torch.matmul)
    rel = max(_rel(x, y) for x, y in zip(got, ref))
    assert (rel <= 1e-5) == within, rel


def _wgrad_by_chunks(a_rows, b_rows, b, t, seg_rows, matmul):
    """A^T B over the rows as the weight-grad kernels sum it: both operands
    transposed into planes whose positions follow ``chunk_positions``
    (zeros elsewhere), one product per chunk over its kc positions, the
    chunks of each segment summed in order, then the segments in order."""
    plan = k4.train_plan(b, t, 1, seg_rows, torch.float32)
    pos = k4.chunk_positions(b, t, seg_rows, plan.kc)
    at = torch.zeros(a_rows.shape[1], plan.rp)
    bt = torch.zeros(b_rows.shape[1], plan.rp)
    at[:, pos] = a_rows.t()
    bt[:, pos] = b_rows.t()
    tot = torch.zeros(a_rows.shape[1], b_rows.shape[1])
    for seg in range(b * t // seg_rows):
        s = torch.zeros_like(tot)
        for k in range(plan.cps):
            cols = slice((seg * plan.cps + k) * plan.kc,
                         (seg * plan.cps + k + 1) * plan.kc)
            s = s + matmul(at[:, cols], bt[:, cols].t())
        tot = tot + s
    return tot


@pytest.mark.parametrize("t", [1000, 2100])
def test_emulated_k5_weight_grads_are_the_sum_of_samples(t):
    """K5's weight grads through the kernels' chunk layout with 3xTF32
    products: the batch equals, bit for bit, the in-order sum of its B=1
    runs (each sample's chunks at the same positions of its own, the same
    products, whatever the batch), and both agree with the true-f32
    product to the f32 limit.  T=2100 gives two chunks per sample (2048
    rows and 52)."""
    b, c = 3, 8
    g = torch.Generator().manual_seed(3)
    a_rows = torch.randn(b * t, c, generator=g)
    b_rows = torch.randn(b * t, 2 * c, generator=g)
    mm = ds.matmul_tf32x3
    got = _wgrad_by_chunks(a_rows, b_rows, b, t, t, mm)
    tot = torch.zeros_like(got)
    for i in range(b):
        rows = slice(i * t, (i + 1) * t)
        tot = tot + _wgrad_by_chunks(a_rows[rows], b_rows[rows], 1, t, t, mm)
    assert torch.equal(got, tot)
    assert _rel(got, a_rows.double().t() @ b_rows.double()) < 1e-5
    assert _rel(_wgrad_by_chunks(a_rows, b_rows, b, t, t, _tf32),
                a_rows.double().t() @ b_rows.double()) > 1e-4
