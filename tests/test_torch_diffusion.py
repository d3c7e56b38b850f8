"""K2 (the sampling ladder), its host tables and GaussianDiffusion.infer in
the torch port against the JAX package on the CPU.

The JAX side samples with its step-by-step scans (the TPU ladder kernel is
off off-TPU) or, for the kernel comparison, runs ``plms_ladder`` in Pallas
interpret mode.  Weights: JAX ``init_params`` (with a nonzero output
projection, so eps is not identically 0) converted by ``jax_to_torch``.
Tolerances are those of tests/test_plms_ladder.py: 2e-4 for PLMS, 3e-4 with
x0 clipping or DPM-Solver++ (f32 sums in another order, over 7-9 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsvc_tpu.config import HParams
from diffsvc_tpu.models import diffusion as jdiff
from diffsvc_tpu.ops.pallas import plms_ladder as JPL
from diffsvc_tpu_torch.models import diffnet
from diffsvc_tpu_torch.models import diffusion as tdiff
from diffsvc_tpu_torch.ops.hopper import plms_ladder as TPL
from diffsvc_tpu_torch.utils.convert import jax_to_torch, load_reference_state

T_MEL, M = 40, 16


def _hp(**kw):
    base = dict(
        audio_num_mel_bins=M, hidden_size=16, residual_layers=4,
        residual_channels=32, dilation_cycle_length=2, timesteps=40,
        K_step=40, diff_loss_type="l2", schedule_type="linear",
        max_beta=0.02, keep_bins=M, spec_min=[-6.0], spec_max=[1.5],
        no_fs2=True, use_pitch_embed=True, use_energy_embed=False,
        use_uv=False, pitch_norm="log", f0_bin=256, f0_min=50.0,
        f0_max=1100.0, pndm_speedup=7, sampler="plms")
    base.update(kw)
    return HParams(**base)


def _batch():
    rng = np.random.RandomState(0)
    return {
        "hubert": (rng.randn(1, T_MEL // 2, 16) * 0.1).astype(np.float32),
        "mel2ph": np.concatenate([rng.randint(1, T_MEL // 2 + 1, T_MEL - 4),
                                  np.zeros(4, int)])[None].astype(np.int64),
        "f0": np.full((1, T_MEL), 7.78, np.float32),
        "uv": np.zeros((1, T_MEL), np.float32),
        "energy": np.zeros((1, T_MEL), np.float32),
        "mels": (rng.randn(1, T_MEL, M) * 0.5 - 2.0).astype(np.float32),
    }


def _models(hp):
    jm = jdiff.GaussianDiffusion(hp)
    params = jm.init_params(jax.random.PRNGKey(0))
    op = params["denoise_fn"]["output_projection"]
    op["w"] = jnp.asarray(np.random.RandomState(5).randn(*op["w"].shape)
                          .astype(np.float32) * 0.2)
    tm = tdiff.GaussianDiffusion(hp)
    load_reference_state(tm, jax_to_torch(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _run_pair(hp_extra, infer_kwargs=None):
    kw = infer_kwargs or {}
    hp = _hp(**hp_extra)
    jm, params, tm = _models(hp)
    batch = _batch()
    rng = jax.random.PRNGKey(1)
    if kw.get("use_gt_mel"):
        noise_rng, _ = jax.random.split(rng)
        noise = np.array(jax.random.normal(noise_rng, (1, T_MEL, M)))
        ref = jm.infer(params, {k: jnp.asarray(v) for k, v in batch.items()},
                       rng, **kw)
    else:
        noise = np.random.RandomState(7).randn(1, T_MEL, M).astype(np.float32)
        ref = jm.infer(params, {k: jnp.asarray(v) for k, v in batch.items()},
                       rng, init_noise=jnp.asarray(noise), **kw)
    got = tm.infer({k: torch.from_numpy(v) for k, v in batch.items()},
                   init_noise=torch.from_numpy(noise), **kw)
    return np.asarray(ref["mel_out"]), got["mel_out"].numpy()


@pytest.mark.parametrize("hp_extra,kw,tol", [
    ({}, {}, 2e-4),
    ({"pndm_speedup": 64}, {}, 2e-4),
    ({}, {"use_gt_mel": True, "add_noise_step": 20}, 2e-4),
    ({"sampler_clip_x0": 1.0}, {}, 3e-4),
    ({"sampler": "dpmpp"}, {}, 3e-4),
    ({"sampler": "dpmpp", "dpmpp_grid": "t"}, {}, 3e-4),
    ({"sampler": "dpmpp", "sampler_clip_x0": 1.0, "pndm_speedup": 13}, {},
     3e-4),
], ids=["plms", "plms-1step", "plms-gtmel", "plms-clip", "dpmpp-lambda",
        "dpmpp-t", "dpmpp-clip"])
def test_infer_matches_jax(hp_extra, kw, tol):
    ref, got = _run_pair(hp_extra, kw)
    assert np.isfinite(got).all() and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=tol, rtol=1e-4)


def test_infer_bf16_matches_jax():
    """bf16 denoiser, f32 sampler state in both; the rounding points differ
    (the port rounds like the TPU kernel), so bf16-scaled bounds as in
    tests/test_plms_ladder.py: max 0.15, mean 0.02."""
    ref, got = _run_pair({"diff_compute_dtype": "bfloat16"})
    assert np.isfinite(got).all()
    assert float(np.abs(got - ref).max()) < 0.15
    assert float(np.abs(got - ref).mean()) < 0.02


def test_clip_binds():
    a, _ = _run_pair({"sampler_clip_x0": 1.0})
    b, _ = _run_pair({})
    assert np.abs(a - b).max() > 1e-3


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
def test_ladder_plain_matches_pallas_interpret(dtype, tol):
    """K2's plain version vs the TPU ladder kernel in interpret mode on the
    same tables, weights and noise (B=1, the TPU kernel's batch)."""
    hp = _hp()
    _, _, tm = _models(hp)
    net = tm.denoise_fn
    p = net.stacked(dtype)
    ac = tm.tables_np["alphas_cumprod"]
    t_eval, scal = TPL.plms_eval_tables(ac, 40, 7)
    step = diffnet.step_embedding(p, torch.from_numpy(t_eval), 32)
    sb = diffnet.step_bias(p, step, dtype).transpose(0, 1).contiguous()
    rng = np.random.RandomState(2)
    cond = torch.from_numpy((rng.randn(1, T_MEL, 16) * 0.5).astype(np.float32))
    cp = diffnet.prepare_cond(net, cond).to(dtype).contiguous()
    x = torch.from_numpy(rng.randn(1, T_MEL, M).astype(np.float32))
    got = TPL.plms_ladder(x, torch.from_numpy(scal), sb, cp, p["win"],
                          p["bin"], p["wskip"], p["bskip"], p["wout"],
                          p["bout"], p["wd"], p["bd"], p["wo"], p["bo"],
                          cycle=2)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def j(a):
        return jnp.asarray(a.float().numpy()).astype(jdt)

    ref = JPL.plms_ladder(
        jnp.asarray(x[0].numpy()),
        jnp.asarray(np.repeat(scal[:, :, None], M, axis=2)),
        j(sb.reshape(-1, 1, 32)), j(cp[:, 0]), j(p["win"]), j(p["bin"][None]),
        j(p["wskip"]), j(p["bskip"][None]), j(p["wout"]), j(p["bout"][None]),
        j(p["wd"]), j(p["bd"][:, None]), j(p["wo"]), j(p["bo"][:, None]),
        cycle=2, n_layers=4, interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), atol=tol,
                               rtol=1e-4 if dtype == torch.float32 else tol)


@pytest.mark.parametrize("sampler", ["plms", "dpmpp"])
def test_scans_match_jax_and_ladder(sampler):
    """The port's step-by-step samplers vs JAX's scans (same denoiser), and
    the port's ladder vs its own scan."""
    hp = _hp(sampler=sampler)
    jm, params, tm = _models(hp)
    rng = np.random.RandomState(4)
    cond = (rng.randn(1, T_MEL, 16) * 0.5).astype(np.float32)
    x = rng.randn(1, T_MEL, M).astype(np.float32)
    jfn = jm._denoise_closure(params, jnp.asarray(cond), hoist_cond=True)
    tfn = tm.denoise_closure(torch.from_numpy(cond))
    jt = jm.tables
    tt = tm.tables("cpu")
    if sampler == "plms":
        ref = jdiff.p_sample_plms_scan(jt, jfn, jnp.asarray(x), 40, 7)
        got = tdiff.p_sample_plms_scan(tt, tfn, torch.from_numpy(x), 40, 7)
    else:
        ref = jdiff.p_sample_dpmpp_2m_scan(jt, jfn, jnp.asarray(x), 40, 7)
        got = tdiff.p_sample_dpmpp_2m_scan(tt, tfn, torch.from_numpy(x), 40, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-4,
                               rtol=1e-4)
    lad = tm._ladder(torch.from_numpy(cond), torch.from_numpy(x), 40, 7, 0.0,
                     sampler)
    np.testing.assert_allclose(lad.numpy(), got.numpy(), atol=3e-4, rtol=1e-4)


CASES = [(40, 7, False), (40, 64, False), (40, 7, True), (1000, 20, False),
         (1000, 20, True), (500, 20, False), (1000, 50, False)]


@pytest.mark.parametrize("t_start,interval,clip", CASES)
def test_plms_tables_equal_jax_bitwise(t_start, interval, clip):
    ac = jdiff.make_tables(jdiff.DiffusionConfig(
        timesteps=max(t_start, 40), K_step=max(t_start, 40),
        schedule_type="linear", max_beta=0.02))["alphas_cumprod"]
    ac = np.asarray(ac)
    te_j, sc_j = JPL.plms_eval_tables(ac, t_start, interval, 4, clip=clip)
    te_t, sc_t = TPL.plms_eval_tables(ac, t_start, interval, clip=clip)
    np.testing.assert_array_equal(te_t, te_j)
    assert (sc_j == sc_j[:, :, :1]).all()
    np.testing.assert_array_equal(sc_t, sc_j[:, :, 0])


@pytest.mark.parametrize("grid", ["lambda", "t"])
@pytest.mark.parametrize("t_start,interval", [(40, 7), (1000, 50),
                                              (1000, 20)])
def test_dpmpp_tables_equal_jax_bitwise(grid, t_start, interval):
    ac = np.asarray(jdiff.make_tables(jdiff.DiffusionConfig(
        timesteps=t_start, K_step=t_start, schedule_type="linear",
        max_beta=0.02))["alphas_cumprod"])
    te_j, sc_j = JPL.dpmpp_eval_tables(ac, t_start, interval, 4, grid=grid)
    te_t, sc_t = TPL.dpmpp_eval_tables(ac, t_start, interval, grid=grid)
    np.testing.assert_array_equal(te_t, te_j)
    np.testing.assert_array_equal(sc_t, sc_j[:, :, 0])


@pytest.mark.parametrize("sampler,grid,rtol", [
    ("plms", None, 2e-5), ("plms-clip", None, 1e-4),
    ("dpmpp", "t", 1e-4), ("dpmpp", "lambda", 5e-4)])
def test_k1000_tables_f32_alphas_vs_f64(sampler, grid, rtol):
    """The ladder's tables are built from the f32 alphas_cumprod table the
    model keeps (as in the JAX package).  At K=1000 (production) they must
    stay close to tables from the exact float64 schedule.  Measured on the
    CPU: PLMS within 1.3e-5 relative, 8.3e-5 with x0 clipping (its 1/sigma
    rows at t=0); DPM-Solver++ on the lambda grid within
    4.4e-4, at its t=1 step, where 1 - alpha_bar ~ 1e-4 loses digits in f32
    (sigma and lambda near t=0); the t grid within 8.4e-5.  The bounds pin
    those measurements so a regression in the f32 path shows up here."""
    betas = np.linspace(1e-4, 0.02, 1000)
    ac64 = np.cumprod(1.0 - betas)
    ac32 = ac64.astype(np.float32)
    assert ac64[-1] < 1e-4
    if sampler == "dpmpp":
        t_a, a = TPL.dpmpp_eval_tables(ac64, 1000, 50, grid=grid)
        t_b, b = TPL.dpmpp_eval_tables(ac32, 1000, 50, grid=grid)
    else:
        clip = sampler == "plms-clip"
        t_a, a = TPL.plms_eval_tables(ac64, 1000, 20, clip=clip)
        t_b, b = TPL.plms_eval_tables(ac32, 1000, 20, clip=clip)
    np.testing.assert_array_equal(t_b, t_a)
    np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-7)
