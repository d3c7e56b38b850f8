"""pe (the PitchExtractor) and ContentVec in the torch port against the JAX
package on the CPU.

- pe: the port's module at small widths (mel 16, hidden 32) with random
  weights and normalizations; its ``state_dict()`` read by JAX's
  ``pe.convert`` (the reference checkpoint's names), and the reference
  checkpoint that ``utils/synth.write_pe`` writes read by both loaders.
  rtol 1e-3 / atol 1e-4 on the predictions, as tests/test_hubert_pe.py.
- ContentVec: a fairseq-layout checkpoint from ``utils/synth.
  write_contentvec`` (dim 32, 10 layers: the layer-9 tap) read by JAX's
  ``convert_fairseq`` and the port's loader; the units at rtol 1e-3 / atol
  1e-4, as the HuBERT converter test; the encoder's ``use_vec`` route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsvc_tpu.models import contentvec as jvec
from diffsvc_tpu.models import hubert as jhubert
from diffsvc_tpu.models import pe as jpe
from diffsvc_tpu.utils import convert_torch as jcvt
from diffsvc_tpu_torch.infer.hubert_encoder import BUCKET, Hubertencoder
from diffsvc_tpu_torch.models import contentvec as tvec
from diffsvc_tpu_torch.models import nn as fnn
from diffsvc_tpu_torch.models import pe as tpe
from diffsvc_tpu_torch.models.hubert import HubertConfig
from diffsvc_tpu_torch.utils import synth

PE_HP = dict(audio_num_mel_bins=16, hidden_size=32, predictor_hidden=-1,
             predictor_kernel=5, pitch_type="frame", use_uv=False,
             pitch_norm="log", f0_mean=0.0, f0_std=1.0)
VEC = dict(dim=32, num_heads=2, num_layers=10, ffn_dim=64, proj_dim=16)


def _mel():
    mel = torch.randn(2, 24, 16, generator=torch.Generator().manual_seed(1))
    mel = mel * 0.5 - 3.0
    mel[1, 17:] = 0.0         # padding frames
    return mel


def _jax_pe(sd):
    params = jpe.convert({k: v.numpy() for k, v in sd.items()})
    cfg = jpe.PEConfig(n_mel_bins=16, hidden_size=32, predictor_hidden=32,
                       conv_layers=2)
    return params, cfg


def test_pe_matches_jax_through_convert():
    model = tpe.PitchExtractor(PE_HP)
    synth.randomize(model, 3)
    synth.randomize_norms(model, 4)
    model.eval()
    mel = _mel()
    got = model(mel)
    params, cfg = _jax_pe(model.state_dict())
    ref = jpe.apply(params, cfg, jnp.asarray(mel.numpy()))
    np.testing.assert_allclose(got["pitch_pred"].numpy(),
                               np.asarray(ref["pitch_pred"]),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got["f0_denorm_pred"].numpy(),
                               np.asarray(ref["f0_denorm_pred"]),
                               rtol=1e-3, atol=1e-4)
    # padded frames give f0 = 0
    assert (got["f0_denorm_pred"][1, 17:] == 0).all()


def test_pe_checkpoint_loads_on_both_sides(tmp_path):
    """write_pe's reference checkpoint: the port's loader restores the
    written module, JAX's convert_pe reads the same file."""
    path = str(tmp_path / "pe" / "model_ckpt_steps_60000.ckpt")
    written = synth.write_pe(path, PE_HP, seed=3)
    loaded = tpe.load(path, PE_HP)
    mel = _mel()
    np.testing.assert_array_equal(loaded(mel)["pitch_pred"].numpy(),
                                  written(mel)["pitch_pred"].numpy())
    params = jcvt.convert_pe(path, PE_HP)
    cfg = jpe.PEConfig(n_mel_bins=16, hidden_size=32, predictor_hidden=32)
    ref = jpe.apply(params, cfg, jnp.asarray(mel.numpy()))
    np.testing.assert_allclose(loaded(mel)["f0_denorm_pred"].numpy(),
                               np.asarray(ref["f0_denorm_pred"]),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("length,offset", [(7, 1), (24, 1), (5, 0)])
def test_positional_table_matches_jax(length, offset):
    from diffsvc_tpu.models import nn as jnn

    np.testing.assert_array_equal(
        fnn.sinusoidal_positional_embedding(length, 32, offset).numpy(),
        np.asarray(jnn.sinusoidal_positional_embedding(length, 32, offset)))


@pytest.fixture(scope="module")
def vec(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vec") / "checkpoint_best.pt")
    synth.write_contentvec(path, HubertConfig(**VEC), seed=5)
    return path


def test_contentvec_matches_jax_through_convert_fairseq(vec):
    """1 s at 16 kHz: the layer-9 features through final_proj, no pad."""
    model = tvec.load(vec, cfg=HubertConfig(**VEC))
    jcfg = jhubert.HubertConfig(**VEC)
    params = jvec.load(vec, jcfg)
    wav = np.random.RandomState(2).randn(1, 16000).astype(np.float32) * 0.1
    got = model.units(torch.from_numpy(wav)).numpy()
    ref = np.asarray(jvec.units(params, jcfg, jnp.asarray(wav)))
    assert got.shape == ref.shape == (1, 49, 16)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_use_vec_route(vec, tmp_path, monkeypatch):
    """Hubertencoder with use_vec loads ContentVec from vec_path and encodes
    as the JAX encoder does: 0.4 s padding, units trimmed to len // 320.
    (The encoder builds the released widths; the tiny checkpoint's are
    patched into its loader.)"""
    load = tvec.load
    monkeypatch.setattr(tvec, "load", lambda path, device: load(
        path, device, HubertConfig(**VEC)))
    enc = Hubertencoder("unused.pt", hp={"use_vec": True, "vec_path": vec})
    assert isinstance(enc.model, tvec.ContentVec)
    wav = np.random.RandomState(3).randn(9000).astype(np.float32) * 0.1
    got = enc.encode(wav)
    jcfg = jhubert.HubertConfig(**VEC)
    padded = np.pad(wav, (0, -(-len(wav) // BUCKET) * BUCKET - len(wav)))
    ref = np.asarray(jvec.units(jvec.load(vec, jcfg), jcfg,
                                jnp.asarray(padded)[None]))[0, :9000 // 320]
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    missing = Hubertencoder("unused.pt", hp={"use_vec": True,
                                             "vec_path": str(tmp_path / "x")})
    with pytest.raises(FileNotFoundError):
        missing.encode(wav)
