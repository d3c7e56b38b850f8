"""The 24 kHz profile of the torch port against the JAX package on the CPU:
the pwg mel and ``wav2spec`` dispatch, the ``HifiGAN`` wrapper (both
checkpoint layouts, the NSF source from shared draws), ``denoise``,
``Svc`` with pe on a tiny 24 kHz project, and ``FusedSvc`` for a vocoder
that is not NSF.

Tiny widths: 16 mel bins, hop 128 at 24 kHz, HiFi-GAN V1's rates (8, 8, 2)
and kernels (16, 16, 4) at 64 initial channels, DiffNet 32 x 4, pe hidden
32.  Tolerances: mels 1e-4 (f32 FFTs of two libraries, as the NSF mel's
test); the vocoder from the same mel and draws 1e-5; the chains 2e-3 on the
waveform, as tests/test_torch_slice.py and tests/test_torch_fused.py hold
the 44.1 kHz chains; denoise 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import TINY_HP, fake_units
from diffsvc_tpu.data import features as jfeat
from diffsvc_tpu.infer.fused import FusedSvc as JFusedSvc
from diffsvc_tpu.infer.svc import Svc as JSvc
from diffsvc_tpu.models import hubert as jhubert
from diffsvc_tpu.models import pe as jpe
from diffsvc_tpu.ops import mel as jmel
from diffsvc_tpu.vocoders import hifigan as jhifigan
from diffsvc_tpu.vocoders import vocoder_utils as jvu
from diffsvc_tpu_torch.data import features as tfeat
from diffsvc_tpu_torch.infer import hubert_encoder
from diffsvc_tpu_torch.infer.fused import FusedSvc
from diffsvc_tpu_torch.infer.svc import Svc as TSvc
from diffsvc_tpu_torch.models.hubert import HubertConfig
from diffsvc_tpu_torch.ops import mel as tmel
from diffsvc_tpu_torch.utils import synth
from diffsvc_tpu_torch.utils.audio_io import save_wav
from diffsvc_tpu_torch.vocoders import hifigan as thifigan
from diffsvc_tpu_torch.vocoders import vocoder_utils as tvu
from diffsvc_tpu_torch.vocoders.base import get_vocoder_cls

SR, HOP, MEL = 24000, 128, 16
HP24 = dict(TINY_HP, audio_sample_rate=SR, hop_size=HOP, fft_size=512,
            win_size=512, fmin=30, fmax=12000, use_nsf=True,
            vocoder="diffsvc_tpu.vocoders.hifigan.HifiGAN")
VOC24 = dict(num_mels=MEL, upsample_initial_channel=64,
             upsample_rates=[8, 8, 2], upsample_kernel_sizes=[16, 16, 4],
             resblock="1", resblock_kernel_sizes=[3, 5],
             resblock_dilation_sizes=[[1, 3], [1, 3]], sampling_rate=SR,
             n_fft=512, win_size=512, hop_size=HOP, fmin=30, fmax=12000)
GEO = dict(sr=SR, n_fft=512, hop=HOP, win_length=512, n_mels=MEL, fmin=30.0,
           fmax=12000.0)
HUB = dict(dim=32, num_heads=2, num_layers=2, ffn_dim=64, proj_dim=32)
ACC = 10


def _voiced(secs, f0=220.0, seed=0):
    return synth.voiced_wav(secs, SR, f0, seed=seed)


def _jax_randoms(rng, length, harmonic_num=8):
    """The NSF draws of JAX's generator.apply from ``rng``."""
    k1, k2 = jax.random.split(rng)
    h = harmonic_num + 1
    return (np.array(jax.random.uniform(k1, (1, h), dtype=jnp.float32)),
            np.array(jax.random.normal(k2, (1, h, length), jnp.float32)))


@pytest.mark.parametrize("n", [24000, 24077])
def test_wav2mel_pwg_and_wav2spec_match_jax(n):
    """The pwg log10-mel (1e-4) and wav2spec's hop-padded wav (exact)."""
    wav = _voiced(n / SR)
    got = tmel.wav2mel_pwg(torch.from_numpy(wav), **GEO).numpy()
    ref = np.asarray(jmel.wav2mel_pwg(jnp.asarray(wav), **GEO))
    assert got.shape == ref.shape == (1 + n // HOP, MEL)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    t_wav, t_mel = tmel.wav2spec(wav, HP24)
    j_wav, j_mel = jmel.wav2spec(wav, HP24)
    np.testing.assert_array_equal(t_wav, j_wav)
    np.testing.assert_allclose(t_mel, j_mel, atol=1e-4)
    assert tmel.librosa_pad_lr(n, 512, HOP, 2) == jmel.librosa_pad_lr(
        n, 512, HOP, 2)
    # loud_norm: -22 LUFS (the copied BS.1770 meter) before the pwg mel
    t_wav, t_mel = tmel.wav2spec(wav, dict(HP24, loud_norm=True))
    j_wav, j_mel = jmel.wav2spec(wav, dict(HP24, loud_norm=True))
    np.testing.assert_array_equal(t_wav, j_wav)
    np.testing.assert_allclose(t_mel, j_mel, atol=1e-4)
    # the tone reads -13.7 LUFS: brought down to -22
    assert np.abs(t_wav).max() < 0.5 * np.abs(wav).max()


def test_wav2spec_for_bucketed_matches_jax(tmp_path):
    """The binarizer's front end on the pwg family: a wav file padded to a
    bucket multiple, the wav and the mel cut back to the true frames."""
    fn = str(tmp_path / "a.wav")
    save_wav(_voiced(0.77), fn, SR)
    hp = dict(HP24, wav_bucket_frames=64)
    t_wav, t_mel = tfeat.wav2spec_for(hp, fn)
    j_wav, j_mel = jfeat.wav2spec_for(hp, fn)
    np.testing.assert_array_equal(t_wav, j_wav)
    assert t_mel.shape == j_mel.shape
    np.testing.assert_allclose(t_mel, j_mel, atol=1e-4)


@pytest.mark.parametrize("layout", ["json", "yaml"])
def test_hifigan_wrapper_matches_jax(tmp_path, layout):
    """HifiGAN from generator_v1 + config.json or config.yaml +
    model_ckpt_steps_*: registered under the config's dotted name; the
    log10-mel vocoded as it is, NSF source from JAX's draws of seed 3."""
    d = str(tmp_path / "voc")
    synth.write_hifigan(d, VOC24, use_nsf=True, seed=1, layout=layout)
    hp = dict(HP24, vocoder_ckpt=d)
    assert get_vocoder_cls(hp) is thifigan.HifiGAN
    tv, jv = thifigan.HifiGAN(hp), jhifigan.HifiGAN(hp)
    rng = np.random.RandomState(0)
    mel = (rng.randn(20, MEL) * 0.5 - 3.0).astype(np.float32)
    f0 = np.full(20, 230.0, np.float32)
    randoms = _jax_randoms(jax.random.PRNGKey(3), 20 * HOP)
    got = tv.spec2wav(mel, f0=f0, randoms=tuple(torch.from_numpy(r)
                                                for r in randoms))
    ref = jv.spec2wav(mel, f0=f0, seed=3)
    assert got.shape == ref.shape == (20 * HOP,)
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # without f0 there is no NSF source
    np.testing.assert_allclose(tv.spec2wav(mel), jv.spec2wav(mel), atol=1e-5)


def test_denoise_matches_jax(tmp_path):
    wav = _voiced(0.4) + 0.05 * np.random.RandomState(1).randn(
        int(0.4 * SR)).astype(np.float32)
    got = tvu.denoise(wav, HP24, v=0.3)
    ref = jvu.denoise(wav, HP24, v=0.3)
    assert got.shape == ref.shape == wav.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # and through the wrapper when vocoder_denoise_c > 0
    d = str(tmp_path / "voc")
    synth.write_hifigan(d, VOC24, use_nsf=False, seed=1)
    hp = dict(HP24, use_nsf=False, vocoder_ckpt=d, vocoder_denoise_c=0.2)
    mel = np.random.RandomState(2).randn(12, MEL).astype(np.float32) - 2.0
    plain = thifigan.HifiGAN(dict(hp, vocoder_denoise_c=0.0)).spec2wav(mel)
    np.testing.assert_allclose(thifigan.HifiGAN(hp).spec2wav(mel),
                               jvu.denoise(plain, hp, v=0.2), atol=1e-5)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_24k")
    cfg_fn, ckpt = synth.write_project(str(root / "proj"), HP24, VOC24,
                                       pe=True)
    wav_fn = str(root / "in.wav")
    save_wav(_voiced(0.8, f0=200.0), wav_fn, SR)
    # a tiny HuBERT for the fused programs (the Svcs take fake units)
    synth.write_hubert(str(root / "hubert_soft.pt"), HubertConfig(**HUB), 2)
    return root, cfg_fn, ckpt, wav_fn


@pytest.fixture
def in_root(project, monkeypatch):
    monkeypatch.chdir(project[0])          # Svc keeps ./infer_tools caches
    return project


def test_svc_with_pe_matches_jax_chain(in_root):
    """Svc.infer on the 24 kHz project with use_pe: the JAX chain (the same
    start noise, pe on the sampled mel, HifiGAN on the log10-mel with the
    NSF draws of seed 0) against the port's facade: pe's f0 rtol 1e-3, the
    waveform 2e-3; and the batched route takes pe's f0 too."""
    _, cfg_fn, ckpt, wav_fn = in_root
    tsvc = TSvc("proj", cfg_fn, False, ckpt, device="cpu")
    jsvc = JSvc("proj", cfg_fn, False, ckpt)
    assert tsvc.pe is not None and jsvc.pe_params is not None
    tsvc.hubert.encode = jsvc.hubert.encode = lambda w: fake_units(w, 32)
    batch = jsvc.pre(wav_fn, ACC, use_crepe=False)
    batch["f0"] = batch["f0"] + 2 / 12
    jb = {k: jnp.asarray(batch[k]) for k in
          ("hubert", "mels", "mel2ph", "energy", "f0", "uv")}
    noise = np.random.RandomState(11).randn(
        *batch["mels"].shape).astype(np.float32)
    out = jsvc.model.infer(jsvc.params, jb, jax.random.PRNGKey(0),
                           speedup=ACC, init_noise=jnp.asarray(noise))
    mel = np.asarray(out["mel_out"])
    f0_pe = np.asarray(jpe.apply(jsvc.pe_params, jsvc.pe_cfg,
                                 jnp.asarray(mel))["f0_denorm_pred"])[0]
    mask = np.abs(mel[0]).sum(-1) > 0
    mel_pred = np.clip(mel[0][mask], jsvc.hp["mel_vmin"], jsvc.hp["mel_vmax"])
    ref_wav = jsvc.vocoder.spec2wav(mel_pred, f0=f0_pe[mask], seed=0)
    randoms = _jax_randoms(jax.random.PRNGKey(0), int(mask.sum()) * HOP)
    _, f0_pred, wav = tsvc.infer(
        wav_fn, key=2, acc=ACC, use_pe=True, use_crepe=False,
        init_noise=noise, voc_randoms=tuple(torch.from_numpy(r)
                                            for r in randoms))
    np.testing.assert_allclose(f0_pred, f0_pe[mask], rtol=1e-3)
    assert not np.allclose(f0_pred, np.asarray(out["f0_denorm"])[0][mask])
    assert wav.shape == ref_wav.shape and np.abs(ref_wav).max() > 1e-3
    np.testing.assert_allclose(wav, ref_wav, atol=2e-3)
    # the batched route: pe's f0 on the group's mel
    (_, b_f0, b_wav), = tsvc.infer_batched(
        [wav_fn], key=2, acc=ACC, use_pe=True, use_crepe=False,
        init_noise=[noise[0]])
    np.testing.assert_allclose(b_f0, f0_pred, rtol=1e-4)
    assert len(b_wav) == len(wav) and np.isfinite(b_wav).all()


def test_fused_24k_matches_jax(project):
    """FusedSvc on the HifiGAN profile (pwg mel, the log10-mel to the
    vocoder with no ln factor, the t_mel = 1 + n // hop geometry) against
    JAX's program on the same draws: waveform and mel 2e-3, f0 rtol
    1e-4."""
    from test_torch_fused import _jax_draws

    root, cfg_fn, ckpt, _ = project
    cwd = os.getcwd()
    os.chdir(root)
    try:
        tsvc = TSvc("proj", cfg_fn, False, ckpt, device="cpu")
        jsvc = JSvc("proj", cfg_fn, False, ckpt)
    finally:
        os.chdir(cwd)
    hub_fn = str(root / "hubert_soft.pt")
    thub = hubert_encoder.load(hub_fn, cfg=HubertConfig(**HUB))
    jcfg = jhubert.HubertConfig(**HUB)
    jf = JFusedSvc(jsvc.hp, jsvc.params, jsvc.vocoder,
                   hubert_params=jhubert.load(hub_fn, jcfg), hubert_cfg=jcfg,
                   speedup=ACC)
    tf = FusedSvc(tsvc.hp, tsvc.model, tsvc.vocoder, thub, speedup=ACC)
    wav = _voiced(0.7, f0=220.0)
    g = tf.geometry(len(wav))
    assert g["t_mel"] == 1 + len(wav) // HOP
    rng = jax.random.PRNGKey(0)
    noise, randoms = _jax_draws(rng, g["pad_t"], g["n_voc"], mel_bins=MEL)
    rw, rf0, rmel = (np.asarray(a) for a in jf(wav, rng, key_shift=2))
    w, f0, mel = tf(wav, key_shift=2, init_noise=noise, voc_randoms=randoms)
    # the port trims to the input's length and ceil(length / hop) frames,
    # where JAX returns an unbucketed program's t_mel * hop samples
    t_true = -(-len(wav) // HOP)
    assert w.shape == (len(wav),) and rw.shape == (g["n_voc"],)
    assert f0.shape == (t_true,) and mel.shape == (t_true, MEL)
    assert np.abs(rw).max() > 1e-3
    np.testing.assert_array_equal(f0 > 0, rf0[:t_true] > 0)
    np.testing.assert_allclose(f0, rf0[:t_true], rtol=1e-4)
    np.testing.assert_allclose(mel, rmel[:t_true], atol=2e-3)
    np.testing.assert_allclose(w, rw[: len(wav)], atol=2e-3)
