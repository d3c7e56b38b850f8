"""The torch port's front end and conditioner against the JAX package on
the CPU: the NSF mel, the AC f0 tracker, HuBERT-soft units (tiny config),
the feature pipeline (alignment, getitem, collate) and the no_fs2
conditioner."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import TINY_HP, voiced_wav
from diffsvc_tpu.data import features as jfeat
from diffsvc_tpu.models import fs2 as jfs2
from diffsvc_tpu.models import hubert as jhubert
from diffsvc_tpu.ops import f0_ac as jf0
from diffsvc_tpu.ops import mel as jmel
from diffsvc_tpu.utils import convert_torch as cvt
from diffsvc_tpu_torch.data import features as tfeat
from diffsvc_tpu_torch.infer import hubert_encoder
from diffsvc_tpu_torch.models import fs2 as tfs2
from diffsvc_tpu_torch.models import hubert as thubert
from diffsvc_tpu_torch.ops import f0_ac as tf0
from diffsvc_tpu_torch.ops import mel as tmel
from diffsvc_tpu_torch.utils.synth import write_hubert

MEL_44K = dict(sr=44100, n_fft=2048, hop=512, win_length=2048, n_mels=128,
               fmin=40.0, fmax=16000.0)
MEL_TINY = dict(sr=8000, n_fft=256, hop=64, win_length=256, n_mels=16,
                fmin=40.0, fmax=4000.0)


@pytest.mark.parametrize("geom", [MEL_44K, MEL_TINY], ids=["44k", "tiny"])
def test_wav2mel_nsf_matches_jax(geom):
    """log10-mel within 1e-4 (f32 FFTs of two libraries)."""
    wav = voiced_wav(secs=0.6, sr=geom["sr"])
    ref = np.asarray(jmel.wav2mel_nsf(jnp.asarray(wav), **geom))
    got = tmel.wav2mel_nsf(torch.from_numpy(wav), **geom).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("f0", [110.0, 220.0, 440.0])
def test_get_pitch_ac_matches_jax(f0):
    """Same frames voiced and the same coarse pitch bins everywhere; f0
    within 0.01% on at least 97% of the voiced frames and within 0.5% on
    all.  The ACF peaks come from f32 FFTs of two libraries: at the edges of
    a silence the signal is the 0.002-level noise floor, where the parabolic
    peak interpolation moved by up to 0.2% on 2 of ~130 frames (measured on
    the CPU)."""
    hp = dict(TINY_HP)
    wav = voiced_wav(secs=1.2, f0=f0, gaps=[(0.5, 0.7)])
    n_mel = 1 + len(wav) // hp["hop_size"]
    ref_f0, ref_c = jf0.get_pitch_ac(wav, n_mel, hp)
    got_f0, got_c = tf0.get_pitch_ac(wav, n_mel, hp)
    assert got_f0.shape == ref_f0.shape == (n_mel,)
    np.testing.assert_array_equal(got_f0 > 0, ref_f0 > 0)
    assert (ref_f0 > 0).sum() > n_mel // 2
    np.testing.assert_array_equal(got_c, ref_c)
    v = ref_f0 > 0
    rel = np.abs(got_f0[v] - ref_f0[v]) / ref_f0[v]
    assert (rel <= 1e-4).mean() >= 0.97 and rel.max() <= 5e-3, rel.max()


def test_hubert_units_match_jax(tmp_path):
    """Tiny HuBERT-soft written as a reference .pt (weight-normed positional
    conv), loaded by both packages; units within 1e-4."""
    cfg_kw = dict(dim=32, num_heads=2, num_layers=2, ffn_dim=64, proj_dim=16)
    path = str(tmp_path / "hubert_soft.pt")
    write_hubert(path, thubert.HubertConfig(**cfg_kw), seed=3)
    model = hubert_encoder.load(path, cfg=thubert.HubertConfig(**cfg_kw))
    jparams = jhubert.load(path, jhubert.HubertConfig(**cfg_kw))
    wav16 = voiced_wav(secs=0.5, sr=16000)[None]
    ref = np.asarray(jhubert.units(jparams, jhubert.HubertConfig(**cfg_kw),
                                   jnp.asarray(wav16)))
    got = model.units(torch.from_numpy(wav16)).numpy()
    assert got.shape == ref.shape == (1, 25, 16)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mel_len,n_units", [(100, 37), (431, 100), (7, 7),
                                             (64, 90)])
def test_align_uniform_matches_jax(mel_len, n_units):
    np.testing.assert_array_equal(tfeat.get_align_uniform(mel_len, n_units),
                                  jfeat.get_align_uniform(mel_len, n_units))


def test_getitem_and_collate_match_jax():
    rng = np.random.RandomState(0)
    items = []
    for n in (50, 37):
        f0 = np.abs(rng.randn(n)) * 100 + 100
        f0[::5] = 0
        items.append({"item_name": f"x{n}", "mel": rng.randn(n, 16) - 3,
                      "f0": f0.astype(np.float32),
                      "pitch": rng.randint(1, 255, n),
                      "hubert": rng.randn(n // 2, 8).astype(np.float32),
                      "mel2ph": jfeat.get_align_uniform(n, n // 2)})
    hp = dict(TINY_HP)
    ref = jfeat.processed_input2batch([jfeat.getitem(i, hp) for i in items],
                                      hp, pad_multiple=16)
    got = tfeat.processed_input2batch([tfeat.getitem(i, hp) for i in items],
                                      hp, pad_multiple=16)
    for k in ("hubert", "mels", "mel2ph", "energy", "pitch", "f0", "uv",
              "mel_lengths"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got[k].dtype == ref[k].dtype, k


@pytest.mark.parametrize("extra", [{}, {"use_energy_embed": True},
                                   {"use_spk_id": True, "num_spk": 3}],
                         ids=["pitch", "energy", "spk"])
def test_fs2_no_fs2_matches_jax(extra):
    hp = dict(TINY_HP, **extra)
    torch.manual_seed(0)
    model = tfs2.FastSpeech2(hp)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jcfg = jfs2.FS2Config.from_hparams(hp)
    jparams = cvt.convert_fs2(sd, jcfg)
    rng = np.random.RandomState(1)
    t = 30
    hubert = rng.randn(2, 12, hp["hidden_size"]).astype(np.float32)
    mel2ph = np.stack([jfeat.get_align_uniform(t, 12),
                       np.r_[jfeat.get_align_uniform(t - 6, 12),
                             np.zeros(6, int)]]).astype(np.int64)
    f0 = (np.log2(150 + 50 * rng.rand(2, t)) - 0.3).astype(np.float32)
    uv = (rng.rand(2, t) > 0.8).astype(np.float32)
    energy = (rng.rand(2, t) * 3).astype(np.float32)
    spk = np.array([1, 2], np.int64)
    ref = jfs2.apply(jparams, jcfg, jnp.asarray(hubert), jnp.asarray(mel2ph),
                     jnp.asarray(f0), jnp.asarray(uv), jnp.asarray(energy),
                     jnp.asarray(spk))
    with torch.no_grad():
        got = model(torch.from_numpy(hubert), torch.from_numpy(mel2ph),
                    torch.from_numpy(f0), torch.from_numpy(uv),
                    torch.from_numpy(energy), torch.from_numpy(spk))
    np.testing.assert_allclose(got["decoder_inp"].numpy(),
                               np.asarray(ref["decoder_inp"]), atol=1e-5)
    np.testing.assert_allclose(got["f0_denorm"].numpy(),
                               np.asarray(ref["f0_denorm"]), rtol=1e-6)
