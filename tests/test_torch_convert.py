"""Checkpoint conversion: ``jax_to_torch`` inverts the JAX package's
converters (``convert_torch``), weight-norm folding matches, and reference
state dicts load into the port's modules by name."""

import numpy as np
import pytest
import torch

from _torch_fixtures import TINY_HP, TINY_VOC
from diffsvc_tpu.models import fs2 as jfs2
from diffsvc_tpu.models import hubert as jhubert
from diffsvc_tpu.utils import convert_torch as cvt
from diffsvc_tpu.vocoders import generator as jgen
from diffsvc_tpu_torch.models.diffusion import GaussianDiffusion
from diffsvc_tpu_torch.models.hubert import HubertConfig, HubertSoft
from diffsvc_tpu_torch.infer import hubert_encoder
from diffsvc_tpu_torch.utils import convert, synth
from diffsvc_tpu_torch.vocoders import nsf_hifigan
from diffsvc_tpu_torch.vocoders.generator import Generator, HifiGanConfig


def _np_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _assert_same(sd_back, module):
    want = module.state_dict()
    assert set(sd_back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd_back[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("extra", [{}, {"use_energy_embed": True,
                                        "use_spk_id": True, "num_spk": 2}],
                         ids=["default", "energy-spk"])
def test_diffusion_roundtrip(extra):
    hp = dict(TINY_HP, **extra)
    torch.manual_seed(0)
    model = GaussianDiffusion(hp)
    sd = _np_sd(model)
    params = {
        "fs2": cvt.convert_fs2(cvt.strip_prefix(sd, "fs2."),
                               jfs2.FS2Config.from_hparams(hp)),
        "denoise_fn": cvt.convert_diffnet(cvt.strip_prefix(sd, "denoise_fn."),
                                          hp["residual_layers"]),
    }
    _assert_same(convert.jax_to_torch(params), model)


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_generator_roundtrip(resblock):
    h = dict(TINY_VOC, resblock=resblock)
    torch.manual_seed(1)
    gen = Generator(HifiGanConfig.from_dict(h, use_nsf=True))
    params = cvt.convert_hifigan_generator(
        _np_sd(gen), jgen.HifiGanConfig.from_dict(h, use_nsf=True))
    _assert_same(convert.jax_to_torch(params), gen)


def test_hubert_roundtrip():
    cfg = dict(dim=32, num_heads=2, num_layers=2, ffn_dim=64, proj_dim=16)
    torch.manual_seed(2)
    model = HubertSoft(HubertConfig(**cfg))
    params = jhubert.convert(_np_sd(model), jhubert.HubertConfig(**cfg))
    _assert_same(convert.jax_to_torch(params), model)


def test_fold_weight_norm_matches_jax():
    rng = np.random.RandomState(0)
    sd = {"a.weight_g": rng.rand(6, 1, 1).astype(np.float32),
          "a.weight_v": rng.randn(6, 4, 3).astype(np.float32),
          "p.weight_g": rng.rand(1, 1, 5).astype(np.float32),   # dim=2
          "p.weight_v": rng.randn(8, 2, 5).astype(np.float32),
          "a.bias": rng.randn(6).astype(np.float32)}
    ref = cvt.fold_weight_norm(sd)
    got = convert.fold_weight_norm({k: torch.from_numpy(v)
                                    for k, v in sd.items()})
    assert set(got) == set(ref) == {"a.weight", "p.weight", "a.bias"}
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-6)


def test_load_reference_state_requires_every_parameter():
    gen = Generator(HifiGanConfig.from_dict(TINY_VOC, use_nsf=True))
    sd = dict(gen.state_dict())
    sd["extra.buffer"] = torch.zeros(1)       # extra reference entries pass
    convert.load_reference_state(gen, sd)
    del sd["conv_post.weight"]
    with pytest.raises(KeyError):
        convert.load_reference_state(gen, sd)


def test_jax_to_torch_rejects_unknown_tree():
    with pytest.raises(ValueError):
        convert.jax_to_torch({"something": {}})


@pytest.mark.parametrize("kind", ["nsf_generator", "hubert"])
def test_synth_checkpoints_load_back(tmp_path, kind):
    """The random-weight writer's weight-normed files (weight_v a scaled
    copy) load through the port's loaders into the weights it drew, within
    f32 rounding of the norm fold."""
    if kind == "nsf_generator":
        want = synth.write_nsf_generator(str(tmp_path / "nsf"), TINY_VOC, 4)
        got, _, _ = nsf_hifigan.load_model(str(tmp_path / "nsf" / "model"))
    else:
        cfg = HubertConfig(dim=32, num_heads=2, num_layers=2, ffn_dim=64,
                           proj_dim=16)
        want = synth.write_hubert(str(tmp_path / "h.pt"), cfg, 4)
        got = hubert_encoder.load(str(tmp_path / "h.pt"), cfg=cfg)
    sd = got.state_dict()
    assert set(sd) == set(want.state_dict())
    for k, v in want.state_dict().items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
