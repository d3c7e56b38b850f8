"""Random-weight projects and synthetic inputs, made from a seed.

The repository holds no trained checkpoints, so the smoke run on the card
(``chip_smoke.py``) and the CPU tests build a project with random weights
in the reference's file formats and convert synthetic voiced clips through
it.  :func:`write_project` writes

- the diffusion ``.ckpt`` (``{"state_dict": {"model.<name>": ...}}``),
- the NSF-HiFiGAN ``generator`` file with weight-normed convs plus its
  sibling ``config.json``,
- optionally a HuBERT-soft ``.pt`` with the weight-normed positional conv,
- and a ``config.yaml`` pointing at them,

so the port and the JAX package load them through their normal loaders.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
import yaml

from ..config import load_config_chain
from ..models.diffusion import GaussianDiffusion
from ..models.hubert import HubertConfig, HubertSoft
from ..vocoders.generator import Generator, HifiGanConfig


def randomize(module: torch.nn.Module, seed: int) -> None:
    """Deterministic weights: torch's default init drawn from ``seed``."""
    torch.manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters") and m is not module:
            m.reset_parameters()


def _weight_norm(sd: dict, names, dim: int = 0) -> dict:
    """Split ``<name>.weight`` into weight_g / weight_v (norm over every dim
    but ``dim``), the layout torch's weight_norm saves.  weight_v is a scaled
    copy, so loading only comes out right if the loader folds the norm
    back."""
    out = dict(sd)
    for name in names:
        w = out.pop(f"{name}.weight")
        axes = tuple(i for i in range(w.dim()) if i != dim)
        out[f"{name}.weight_g"] = torch.sqrt((w ** 2).sum(dim=axes,
                                                          keepdim=True))
        out[f"{name}.weight_v"] = w * 1.7
    return out


def write_nsf_generator(dirpath: str, voc_h: dict, seed: int = 0) -> Generator:
    """NSF-HiFiGAN ``model`` ({"generator": state dict}) + ``config.json``."""
    gen = Generator(HifiGanConfig.from_dict(voc_h, use_nsf=True))
    randomize(gen, seed)
    wn = ["conv_pre", "conv_post"] + [f"ups.{i}" for i in range(len(gen.ups))]
    for i, blk in enumerate(gen.resblocks):
        for key in ("convs1", "convs2", "convs"):
            wn += [f"resblocks.{i}.{key}.{d}"
                   for d in range(len(getattr(blk, key, ())))]
    os.makedirs(dirpath, exist_ok=True)
    torch.save({"generator": _weight_norm(gen.state_dict(), wn)},
               os.path.join(dirpath, "model"))
    with open(os.path.join(dirpath, "config.json"), "w") as f:
        json.dump(voc_h, f)
    return gen


def write_hubert(path: str, cfg: HubertConfig, seed: int = 0) -> HubertSoft:
    """HuBERT-soft ``.pt`` (bare state dict, weight-normed positional conv)."""
    model = HubertSoft(cfg)
    randomize(model, seed)
    sd = _weight_norm(model.state_dict(), ["positional_embedding.conv"],
                      dim=2)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(sd, path)
    return model


def write_project(root: str, config: dict, voc_h: dict,
                  hubert_cfg: HubertConfig | None = None):
    """Write a project under ``root`` and return (config.yaml, ckpt path).

    :param config: the config.yaml's entries: a whole hparams dict, or one
        that inherits others through ``base_config``.  The paths of the
        vocoder and HuBERT files are added to it.
    :param voc_h: the NSF-HiFiGAN geometry (its ``config.json``)
    :param hubert_cfg: write a HuBERT-soft ``.pt`` of this size; None writes
        none (the caller then supplies units another way)

    The weights are torch's default init drawn from seeds 0 (diffusion),
    1 (vocoder) and 2 (HuBERT).
    """
    os.makedirs(root, exist_ok=True)
    cfg = dict(config,
               vocoder_ckpt=os.path.join(root, "nsf_hifigan", "model"),
               hubert_path=os.path.join(root, "hubert", "hubert_soft.pt"))
    cfg_fn = os.path.join(root, "config.yaml")
    with open(cfg_fn, "w") as f:
        yaml.safe_dump(cfg, f)
    model = GaussianDiffusion(load_config_chain(cfg_fn))
    randomize(model, 0)
    ckpt = os.path.join(root, "model_ckpt_steps_1000.ckpt")
    torch.save({"state_dict": {f"model.{k}": v.clone()
                               for k, v in model.state_dict().items()},
                "epoch": 0, "global_step": 1000}, ckpt)
    write_nsf_generator(os.path.dirname(cfg["vocoder_ckpt"]), voc_h, 1)
    if hubert_cfg is not None:
        write_hubert(cfg["hubert_path"], hubert_cfg, 2)
    return cfg_fn, ckpt


def voiced_wav(secs: float, sr: int, f0: float = 220.0, gaps=(),
               seed: int = 0) -> np.ndarray:
    """A vibrato tone with two harmonics and a little noise; ``gaps`` are
    (start_s, end_s) spans set to silence."""
    t = np.arange(int(sr * secs)) / sr
    ph = 2 * np.pi * np.cumsum(f0 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))) / sr
    wav = 0.3 * np.sin(ph) + 0.1 * np.sin(2 * ph) + 0.05 * np.sin(3 * ph)
    wav += 0.002 * np.random.RandomState(seed).randn(len(t))
    for a, b in gaps:
        wav[int(a * sr): int(b * sr)] = 0.0
    return wav.astype(np.float32)


def stack_inputs(dtype, device, b: int, t: int, c: int, layers: int) -> dict:
    """Operands of K1 (``ops/hopper/diffnet_stack.residual_stack``) with O(1)
    activations: x0 [B,T,C], sb [L,B,C], cond_proj [L,B,T,2C],
    wd [L,3,C,2C], bd [L,2C], wo [L,C,2C], bo [L,2C]."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device, dtype)

    return dict(x0=r(b, t, c).abs(), sb=r(layers, b, c, scale=0.3),
                cond_proj=r(layers, b, t, 2 * c, scale=0.5),
                wd=r(layers, 3, c, 2 * c, scale=1 / math.sqrt(3 * c)),
                bd=r(layers, 2 * c, scale=0.1),
                wo=r(layers, c, 2 * c, scale=1 / math.sqrt(c)),
                bo=r(layers, 2 * c, scale=0.1))
