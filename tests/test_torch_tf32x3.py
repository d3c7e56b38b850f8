"""The arithmetic of K1's and K2's f32 route on the CPU: the TF32 split and
the 3xTF32 products, held against the JAX package's f32.

The f32 kernels (``csrc/diffnet_layer_tf32x3.cuh``) split every operand as
a = hi + lo (``diffnet_stack.split_tf32``) and sum a_lo b_hi + a_hi b_lo +
a_hi b_hi on the tensor cores.  Here the plain versions run with each
product replaced by those three (``diffnet_stack.matmul_tf32x3``) and must
stay within the f32 limits of the JAX references the parity tests already
use: ``jdiffnet.apply`` and ``residual_stack`` in Pallas interpret mode at
1e-5, the ladder in interpret mode and the PLMS and DPM-Solver++ scans at
1e-4.  The same runs with single-pass TF32 products (a_hi b_hi alone) must
exceed those limits, so these tests can see a kernel that drops the lo
terms.  The ladders are compared on the part of x the denoiser put there
(x minus the same ladder with the output projection zeroed), as
``chip_smoke.py`` compares them.  The kernels themselves run in
``test_torch_cuda.py`` (``gpu``) and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsvc_tpu.models import diffnet as jdiffnet
from diffsvc_tpu.models import diffusion as jdiff
from diffsvc_tpu.ops.pallas import diffnet_stack as jstack
from diffsvc_tpu.ops.pallas import plms_ladder as JPL
from diffsvc_tpu_torch.models import diffnet
from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
from diffsvc_tpu_torch.ops.hopper import plms_ladder as TPL

from test_torch_diffnet import C, _inputs, _pair
from test_torch_diffusion import M, T_MEL, _hp, _models


def _bits(a):
    return a.contiguous().view(torch.int32)


def _tf32(a, b):
    """Single-pass TF32 products: what a kernel without the lo terms
    computes."""
    return ds.split_tf32(a)[0] @ ds.split_tf32(b)[0]


PRODUCTS = {"tf32x3": ds.matmul_tf32x3, "tf32": _tf32}
# (products, whether they stay within the f32 limit)
ROUTES = [("tf32x3", True), ("tf32", False)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# The split
# ---------------------------------------------------------------------------

def _rna_reference(a):
    """TF32 rounding (10 explicit mantissa bits, ties away from zero) of
    normal f32 values, computed in float64 from the value, not its bits."""
    x = a.double()
    mag = x.abs()
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 10)
    return torch.sign(x) * torch.floor(mag / ulp + 0.5) * ulp


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7e4, 1e30])
def test_split_tf32_bits_and_reconstruction(scale):
    g = torch.Generator().manual_seed(0)
    a = (torch.randn(4096, generator=g) * scale).float()
    hi, lo = ds.split_tf32(a)
    assert hi.dtype == lo.dtype == torch.float32
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    assert torch.equal(hi.double(), _rna_reference(a))
    err = (a.double() - (hi.double() + lo.double())).abs()
    assert (err <= 2.0 ** -22 * a.double().abs()).all()
    # hi alone is single-pass TF32: ~2^-11, which the lo plane removes
    assert ((a - hi).abs() <= 2.0 ** -11 * a.abs()).all()
    assert float((a - hi).abs().max()) > 2.0 ** -14 * float(a.abs().max())


def test_split_tf32_ties_signs_zeros_subnormals():
    tie = 1.0 + 2.0 ** -11                      # halfway between TF32 values
    a = torch.tensor([tie, -tie, 0.0, -0.0, 1.0, -3.5], dtype=torch.float32)
    hi, lo = ds.split_tf32(a)
    # ties round away from zero, as cvt.rna; the remainder goes to lo
    assert hi[0] == 1.0 + 2.0 ** -10 and hi[1] == -(1.0 + 2.0 ** -10)
    assert lo[0] == -(2.0 ** -11) and lo[1] == 2.0 ** -11
    # zeros keep their sign in hi; exact TF32 values have lo == 0
    assert _bits(hi)[2] == 0 and _bits(hi)[3] == -(2 ** 31)
    assert torch.equal(hi[2:], a[2:]) and not lo[2:].any()
    # subnormals round at the same bit position: within 2^-137
    sub = torch.tensor([1e-40, -3e-42, 2.0 ** -149, 2.0 ** -136],
                       dtype=torch.float32)
    hi, lo = ds.split_tf32(sub)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    err = (sub.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -137).all()
    assert hi[3] == 2.0 ** -136 and lo[3] == 0      # a TF32 subnormal


def test_matmul_tf32x3_is_f32_accurate():
    g = torch.Generator().manual_seed(1)
    a = torch.randn(64, 384, generator=g)
    b = torch.randn(384, 96, generator=g) / 20
    exact = a.double() @ b.double()
    # both at the f32 sums' own error (~2.5e-7 at K = 384)
    assert _rel(ds.matmul_tf32x3(a, b), exact) < 5e-7
    assert _rel(a @ b, exact) < 5e-7
    assert _rel(_tf32(a, b), exact) > 1e-4


# ---------------------------------------------------------------------------
# K1: the stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route,within", ROUTES)
@pytest.mark.parametrize("layers,cycle", [(4, 4), (6, 3)])
def test_emulated_stack_matches_jax_apply(monkeypatch, layers, cycle, route,
                                          within):
    """The denoiser with K1's products emulated (CPU: the plain stack)
    against ``jdiffnet.apply`` at 1e-5, as test_torch_diffnet holds the
    true-f32 port."""
    net, jp, jcfg = _pair(layers, cycle)
    spec, cond, steps = _inputs()
    ref = np.asarray(jdiffnet.apply(jp, jcfg, jnp.asarray(spec),
                                    jnp.asarray(steps), jnp.asarray(cond),
                                    inference=True))
    plain = ds.residual_stack_plain
    monkeypatch.setattr(ds, "residual_stack", lambda *a, **k: plain(
        *a, matmul=PRODUCTS[route], **k))
    got = diffnet.apply(net, torch.from_numpy(spec), torch.from_numpy(steps),
                        torch.from_numpy(cond)).numpy()
    assert np.allclose(got, ref, rtol=1e-5, atol=1e-5) == within


@pytest.mark.parametrize("route,within", ROUTES)
def test_emulated_stack_matches_pallas_interpret(route, within):
    """K1's plain version with the emulated products against the TPU kernel
    in interpret mode at f32, per sample, at 1e-5."""
    net, _, _ = _pair()
    p = net.stacked(torch.float32)
    rng = np.random.RandomState(3)
    b, t = 2, 48
    x0 = torch.from_numpy(np.abs(rng.randn(b, t, C)).astype(np.float32))
    sb = torch.from_numpy(rng.randn(4, b, C).astype(np.float32) * 0.3)
    cp = torch.from_numpy(rng.randn(4, b, t, 2 * C).astype(np.float32) * 0.3)
    got = ds.residual_stack_plain(x0, sb, cp, p["wd"], p["bd"], p["wo"],
                                  p["bo"], cycle=4, matmul=PRODUCTS[route])
    ok = []
    for i in range(b):
        ref = jstack.residual_stack(
            *(jnp.asarray(a.numpy()) for a in (x0[i], sb[:, i], cp[:, i],
                                               p["wd"], p["bd"], p["wo"],
                                               p["bo"])),
            cycle=4, interpret=True)
        ok.append(np.allclose(got[i].numpy(), np.asarray(ref), rtol=1e-5,
                              atol=1e-5))
    assert all(ok) == within and any(ok) == within


# ---------------------------------------------------------------------------
# K2: the ladder
# ---------------------------------------------------------------------------

def _ladder_args(tm, sampler="plms"):
    net = tm.denoise_fn
    p = net.stacked(torch.float32)
    ac = tm.tables_np["alphas_cumprod"]
    if sampler == "plms":
        t_eval, scal = TPL.plms_eval_tables(ac, 40, 7)
    else:
        t_eval, scal = TPL.dpmpp_eval_tables(ac, 40, 7)
    step = diffnet.step_embedding(p, torch.from_numpy(t_eval), 32)
    sb = diffnet.step_bias(p, step, torch.float32).transpose(0, 1).contiguous()
    rng = np.random.RandomState(2)
    cond = torch.from_numpy((rng.randn(1, T_MEL, 16) * 0.5).astype(np.float32))
    cp = diffnet.prepare_cond(net, cond).contiguous()
    x = torch.from_numpy(rng.randn(1, T_MEL, M).astype(np.float32))
    return dict(x_init=x, scal=torch.from_numpy(scal), sb_tab=sb,
                cond_proj=cp, win=p["win"], bin_=p["bin"], wskip=p["wskip"],
                bskip=p["bskip"], wout=p["wout"], bout=p["bout"], wd=p["wd"],
                bd=p["bd"], wo=p["wo"], bo=p["bo"])


def _eps_free(a, **kw):
    """The ladder with eps = 0 (output projection zeroed): what x holds
    without the denoiser."""
    return TPL.plms_ladder_plain(**dict(a, wout=torch.zeros_like(a["wout"]),
                                        bout=torch.zeros_like(a["bout"])),
                                 **kw)


@pytest.mark.parametrize("route,within", ROUTES)
def test_emulated_ladder_matches_pallas_interpret(route, within):
    """K2's plain version with the emulated products against the TPU ladder
    kernel in interpret mode at f32 (B=1), at 1e-4 on the denoiser's part
    of x."""
    _, _, tm = _models(_hp())
    a = _ladder_args(tm)
    got = TPL.plms_ladder_plain(**a, cycle=2, matmul=PRODUCTS[route])
    scal = a["scal"].numpy()

    def j(v):
        return jnp.asarray(v.float().numpy())

    ref = np.asarray(JPL.plms_ladder(
        j(a["x_init"][0]), jnp.asarray(np.repeat(scal[:, :, None], M, axis=2)),
        j(a["sb_tab"].reshape(-1, 1, 32)), j(a["cond_proj"][:, 0]),
        j(a["win"]), j(a["bin_"][None]), j(a["wskip"]), j(a["bskip"][None]),
        j(a["wout"]), j(a["bout"][None]), j(a["wd"]), j(a["bd"][:, None]),
        j(a["wo"]), j(a["bo"][:, None]), cycle=2, n_layers=4,
        interpret=True))
    base = _eps_free(a, cycle=2)[0].numpy()
    assert (_rel(got[0].numpy() - base, ref - base) <= 1e-4) == within


@pytest.mark.parametrize("route,within", ROUTES)
@pytest.mark.parametrize("sampler", ["plms", "dpmpp"])
def test_emulated_ladder_matches_jax_scans(monkeypatch, sampler, route,
                                           within):
    """GaussianDiffusion's ladder with K2's products emulated against JAX's
    step-by-step PLMS and DPM-Solver++(2M) scans over the same denoiser, at
    1e-4 on the denoiser's part of x."""
    hp = _hp(sampler=sampler)
    jm, params, tm = _models(hp)
    rng = np.random.RandomState(4)
    cond = (rng.randn(1, T_MEL, 16) * 0.5).astype(np.float32)
    x = rng.randn(1, T_MEL, M).astype(np.float32)
    jfn = jm._denoise_closure(params, jnp.asarray(cond), hoist_cond=True)
    scan = (jdiff.p_sample_plms_scan if sampler == "plms"
            else jdiff.p_sample_dpmpp_2m_scan)
    ref = np.asarray(scan(jm.tables, jfn, jnp.asarray(x), 40, 7))

    def ladder(matmul):
        monkeypatch.setattr(TPL, "plms_ladder", lambda *a, **k: (
            TPL.plms_ladder_plain(*a, matmul=matmul, **k)))
        return tm._ladder(torch.from_numpy(cond), torch.from_numpy(x), 40, 7,
                          0.0, sampler).numpy()

    got = ladder(PRODUCTS[route])
    head = tm.denoise_fn.output_projection
    saved = head.weight.detach().clone(), head.bias.detach().clone()
    with torch.no_grad():
        head.weight.zero_()
        head.bias.zero_()
    base = ladder(torch.matmul)
    with torch.no_grad():
        head.weight.copy_(saved[0])
        head.bias.copy_(saved[1])
    assert (_rel(got - base, ref - base) <= 1e-4) == within
