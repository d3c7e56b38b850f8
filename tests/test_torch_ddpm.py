"""DDPM sampling (``acc <= 1``), ``sampler_clip_x0`` on it,
``OfflineGaussianDiffusion`` and K1's kept weight packs, in the torch port
against the JAX package on the CPU.

The per-step noise is JAX's own key sequence (``rng, nkey = split(rng)``,
``normal(nkey)`` per step, after ``noise_rng, samp_rng = split(rng)`` in
``GaussianDiffusion.infer``), built here and passed to the port as
``step_noise``.  Tiny widths (DiffNet 32 x 4, 16 mel bins) and K_step 40.
Tolerance: 2e-4 absolute (+1e-4 relative) on the sampled mel, as
tests/test_torch_diffusion.py holds PLMS: f32 sums in another order over 40
evaluations; the sampler's own arithmetic (the standalone scan) to 1e-5; the
fused program at acc=1 (K_step 50) at tests/test_torch_fused.py's limits.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import voiced_wav
from diffsvc_tpu.infer.fused import FusedSvc as JFusedSvc
from diffsvc_tpu.models import diffusion as jdiff
from diffsvc_tpu_torch.infer.fused import FusedSvc
from diffsvc_tpu_torch.models import diffusion as tdiff
from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
from diffsvc_tpu_torch.utils.convert import jax_to_torch, load_reference_state

from test_torch_diffusion import M, T_MEL, _batch, _hp
# the fused program's fixtures: a tiny project with a tiny HuBERT on both
# sides
from test_torch_fused import _jax_draws, project, sides  # noqa: F401

TOL = 2e-4


def _jax_step_noise(samp_rng, n_steps, shape):
    """The noise p_sample_ddpm_scan draws at each of its n_steps steps."""
    out, rng = [], samp_rng
    for _ in range(n_steps):
        rng, nkey = jax.random.split(rng)
        out.append(np.asarray(jax.random.normal(nkey, shape, jnp.float32)))
    return np.stack(out)


def _models(hp, cls_j=jdiff.GaussianDiffusion, cls_t=tdiff.GaussianDiffusion):
    jm = cls_j(hp)
    params = jm.init_params(jax.random.PRNGKey(0))
    op = params["denoise_fn"]["output_projection"]
    op["w"] = jnp.asarray(np.random.RandomState(5).randn(*op["w"].shape)
                          .astype(np.float32) * 0.2)
    tm = cls_t(hp)
    load_reference_state(tm, jax_to_torch(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _pair(hp_extra=None, kw=None, batch_extra=None, offline=False):
    """(JAX mel_out, port mel_out) of one infer at acc=1 on shared noise."""
    kw = dict(kw or {})
    hp = _hp(pndm_speedup=1, **(hp_extra or {}))
    cls = ((jdiff.OfflineGaussianDiffusion, tdiff.OfflineGaussianDiffusion)
           if offline else (jdiff.GaussianDiffusion, tdiff.GaussianDiffusion))
    jm, params, tm = _models(hp, *cls)
    batch = dict(_batch(), **(batch_extra or {}))
    rng = jax.random.PRNGKey(1)
    noise_rng, samp_rng = jax.random.split(rng)
    gt = kw.get("use_gt_mel") or (offline and not hp.get("gaussian_start",
                                                         True))
    n_steps = int(kw.get("add_noise_step", hp["K_step"])) if gt \
        else hp["K_step"]
    step_noise = _jax_step_noise(samp_rng, n_steps, (1, T_MEL, M))
    if gt:
        noise = np.array(jax.random.normal(noise_rng, (1, T_MEL, M)))
        ref = jm.infer(params, {k: jnp.asarray(v) for k, v in batch.items()},
                       rng, speedup=1, **kw)
    else:
        noise = np.random.RandomState(7).randn(1, T_MEL, M).astype(np.float32)
        ref = jm.infer(params, {k: jnp.asarray(v) for k, v in batch.items()},
                       rng, speedup=1, init_noise=jnp.asarray(noise), **kw)
    got = tm.infer({k: torch.from_numpy(v) for k, v in batch.items()},
                   speedup=1, init_noise=torch.from_numpy(noise),
                   step_noise=torch.from_numpy(step_noise), **kw)
    return np.asarray(ref["mel_out"]), got["mel_out"].numpy()


@pytest.mark.parametrize("clip", [True, False], ids=["clip", "noclip"])
def test_ddpm_scan_matches_jax(clip):
    """p_sample_ddpm_scan alone, on a denoiser both sides compute alike
    (eps = 0.7 tanh(x) + t/1000): the posterior update, clip_denoised and
    the t=0 mask, 1e-5."""
    hp = _hp()
    tabs_j = jdiff.make_tables(jdiff.DiffusionConfig.from_hparams(hp))
    tabs_t = {k: torch.from_numpy(v) for k, v in tdiff.make_tables(
        40, "linear", 0.02).items()}
    x0 = np.random.RandomState(3).randn(2, 12, M).astype(np.float32) * 2.0
    rng = jax.random.PRNGKey(4)
    noise = _jax_step_noise(rng, 40, x0.shape)

    def fn_j(x, t):
        return 0.7 * jnp.tanh(x) + t[:, None, None] / 1000.0

    def fn_t(x, t):
        return 0.7 * torch.tanh(x) + t[:, None, None] / 1000.0

    ref = np.asarray(jdiff.p_sample_ddpm_scan(tabs_j, fn_j, jnp.asarray(x0),
                                              40, rng, clip_denoised=clip))
    got = tdiff.p_sample_ddpm_scan(tabs_t, fn_t, torch.from_numpy(x0), 40,
                                   step_noise=torch.from_numpy(noise),
                                   clip_denoised=clip).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    # the last step (t=0) adds no noise: its draw does not matter
    noise[-1] = 1e3
    again = tdiff.p_sample_ddpm_scan(tabs_t, fn_t, torch.from_numpy(x0), 40,
                                     step_noise=torch.from_numpy(noise),
                                     clip_denoised=clip).numpy()
    np.testing.assert_array_equal(again, got)
    with pytest.raises(ValueError, match="steps"):
        tdiff.p_sample_ddpm_scan(tabs_t, fn_t, torch.from_numpy(x0), 39,
                                 step_noise=torch.from_numpy(noise))


@pytest.mark.parametrize("hp_extra,kw", [
    ({}, {}),
    ({}, {"use_gt_mel": True, "add_noise_step": 20}),
    ({"sampler_clip_x0": 0.8}, {}),
], ids=["ddpm", "ddpm-gtmel", "ddpm-clip"])
def test_infer_acc1_matches_jax(hp_extra, kw):
    """GaussianDiffusion.infer at acc=1 against JAX's: the start noise (or
    use_gt_mel's q_sample), 40 (or 20) DDPM steps through the denoiser,
    sampler_clip_x0 around it."""
    ref, got = _pair(hp_extra, kw)
    assert np.isfinite(got).all() and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=1e-4)


def test_ddpm_clip_binds_and_generator_draws():
    """The x0 clip changes the DDPM result; without step_noise the draws
    come from the caller's generator (same seed, same mel)."""
    a, _ = _pair({"sampler_clip_x0": 0.8})
    b, _ = _pair({})
    assert np.abs(a - b).max() > 1e-3
    hp = _hp(pndm_speedup=1)
    _, _, tm = _models(hp)
    tb = {k: torch.from_numpy(v) for k, v in _batch().items()}
    outs = [tm.infer(tb, speedup=1, generator=torch.Generator().manual_seed(
        s))["mel_out"] for s in (0, 0, 1)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert torch.isfinite(outs[0]).all()


@pytest.mark.parametrize("gaussian_start", [True, False],
                         ids=["gaussian", "fs2_start"])
def test_offline_diffusion_matches_jax(gaussian_start):
    """OfflineGaussianDiffusion with fs2_mels: gaussian_start samples from
    noise as the parent does; without it the start is fs2_mels q-sampled to
    K_step-1 (use_gt_mel at add_noise_step = K_step)."""
    fs2 = (np.random.RandomState(9).randn(1, T_MEL, M) * 0.4 - 3.0
           ).astype(np.float32)
    ref, got = _pair({"gaussian_start": gaussian_start}, {},
                     {"fs2_mels": fs2}, offline=True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=1e-4)
    if not gaussian_start:
        base, _ = _pair({"gaussian_start": True}, {}, {"fs2_mels": fs2},
                        offline=True)
        assert np.abs(base - ref).max() > 1e-3


def test_k1_packs_once_per_weight_version():
    """K1's packed weights are kept per (wd, wo) pair and version: a
    repeated call packs nothing, an in-place change repacks, another tensor
    packs, and an entry dies with its wd."""
    g = torch.Generator().manual_seed(0)
    wd = torch.randn(2, 3, 40, 80, generator=g)
    wo = torch.randn(2, 40, 80, generator=g)
    before = ds.packs
    first = ds.packed_layers(wd, wo, 64)
    again = ds.packed_layers(wd, wo, 64)
    assert ds.packs == before + 1
    assert all(a is b for a, b in zip(first, again))
    ref = ds.pack_layers(wd, wo, 64)
    assert all(torch.equal(a, b) for a, b in zip(first, ref))
    with torch.no_grad():
        wo.mul_(2.0)
    repacked = ds.packed_layers(wd, wo, 64)
    assert ds.packs == before + 2
    assert torch.equal(repacked[1], ds.pack_layers(wd, wo, 64)[1])
    ds.packed_layers(wd, wo.clone(), 64)
    assert ds.packs == before + 3
    n = len(ds._packed)
    del wd, first, again, repacked
    gc.collect()
    assert len(ds._packed) == n - 1


def test_fused_ddpm_matches_jax(sides):
    """FusedSvc at acc=1: the per-step noise enters as an input (JAX's
    draws from split(rng)[1]); waveform, f0 and mel against JAX's fused
    program at tests/test_torch_fused.py's limits (2e-3, f0 rtol 1e-4)."""
    tsvc, thub, jsvc, jhp, jcfg = sides
    jf = JFusedSvc(jsvc.hp, jsvc.params, jsvc.vocoder, hubert_params=jhp,
                   hubert_cfg=jcfg, speedup=1)
    tf = FusedSvc(tsvc.hp, tsvc.model, tsvc.vocoder, thub, speedup=1)
    assert tf.ddpm_steps() == tsvc.model.K_step
    assert tf.ddpm_steps(use_gt_mel=True, add_noise_step=7) == 7
    wav = voiced_wav(secs=0.6, f0=220.0)
    g = tf.geometry(len(wav))
    rng = jax.random.PRNGKey(0)
    noise, randoms = _jax_draws(rng, g["pad_t"], g["n_voc"])
    steps = _jax_step_noise(jax.random.split(rng)[1], tf.ddpm_steps(),
                            (1, g["pad_t"], 16))
    rw, rf0, rmel = (np.asarray(a) for a in jf(wav, rng, key_shift=2))
    w, f0, mel = tf(wav, key_shift=2, init_noise=noise, voc_randoms=randoms,
                    step_noise=steps)
    assert w.shape == rw.shape and np.abs(rw).max() > 1e-2
    np.testing.assert_allclose(f0, rf0, rtol=1e-4)
    np.testing.assert_allclose(mel, rmel, atol=2e-3)
    np.testing.assert_allclose(w, rw, atol=2e-3)
