"""The 24 kHz HiFi-GAN vocoder wrapper and shared helpers.

Counterpart of ``diffsvc_tpu/vocoders/hifigan.py:48-120`` (reference
``network/vocoders/hifigan.py``): ``HifiGAN`` loads a reference
checkpoint, ``config.yaml`` + the latest ``model_ckpt_steps_*`` (the
generator under ``state_dict.model_gen``, else ``generator``) or
``config.json`` + ``generator_v1``, folds weight norm, and synthesizes the
log10-mel as it is (no ln conversion) through :func:`generator.
apply_serving` (K3 on a CUDA device), with the NSF source when ``use_nsf``
is set in hp and an f0 is given; ``vocoder_denoise_c > 0`` runs
:func:`vocoder_utils.denoise` on the result.  Its ``wav2spec`` is the pwg
mel (``ops/mel.wav2spec``).  :func:`bucket_mel_f0` is shared with the
NSF-HiFiGAN wrapper.
"""

from __future__ import annotations

import glob
import json
import os
import re

import numpy as np
import torch

from ..ops import mel as mel_ops
from ..utils import convert
from . import generator
from .base import BaseVocoder, register_vocoder


def bucket_mel_f0(hp, mel, f0):
    """Opt-in vocoder length bucketing (``voc_bucket_frames``): pad the mel
    time axis up to a bucket multiple with the utterance's silence floor
    (f0 padded with 0); callers trim the wav back to t_real*hop.  Off (0) by
    default.  Returns (mel, f0, t_real)."""
    bucket = int(hp.get("voc_bucket_frames", 0) or 0)
    mel = np.asarray(mel, np.float32)
    t_real = mel.shape[0]
    if bucket <= 1 or t_real % bucket == 0:
        return mel, f0, t_real
    pad = bucket - t_real % bucket
    mel = np.pad(mel, ((0, pad), (0, 0)), constant_values=float(mel.min()))
    if f0 is not None:
        f0 = np.pad(np.asarray(f0, np.float32), (0, pad))
    return mel, f0, t_real


def load_model(config_path: str, file_path: str, use_nsf: bool,
               device="cpu"):
    """(Generator on ``device`` in eval mode, its config, the config
    dict) from a reference HiFi-GAN checkpoint."""
    if config_path.endswith(".yaml"):
        from ..config import load_config_chain

        config = load_config_chain(config_path)
    else:
        with open(config_path, encoding="utf-8") as f:
            config = json.load(f)
    ckpt = convert.torch_load(file_path)
    if file_path.endswith(".ckpt") and "model_gen" in ckpt.get(
            "state_dict", {}):
        state = ckpt["state_dict"]["model_gen"]
    else:
        state = ckpt.get("generator", ckpt)
    cfg = generator.HifiGanConfig.from_dict(config, use_nsf=use_nsf)
    gen = generator.Generator(cfg)
    convert.load_reference_state(gen, convert.fold_weight_norm(state))
    print(f"| Loaded HifiGAN generator from {file_path}")
    return gen.to(device).eval(), cfg, config


@register_vocoder
class HifiGAN(BaseVocoder):
    def __init__(self, hp, device="cpu"):
        self.hp = hp
        self.device = torch.device(device)
        base_dir = hp["vocoder_ckpt"]
        use_nsf = bool(hp.get("use_nsf"))
        config_path = f"{base_dir}/config.yaml"
        if os.path.exists(config_path):
            file_path = sorted(
                glob.glob(f"{base_dir}/model_ckpt_steps_*.*"),
                key=lambda x: int(re.findall(r"model_ckpt_steps_(\d+)",
                                             x)[0]))[-1]
        else:
            config_path = f"{base_dir}/config.json"
            file_path = f"{base_dir}/generator_v1"
            if not os.path.exists(config_path):
                raise FileNotFoundError(f"no vocoder config under {base_dir}")
        self.gen, self.cfg, self.config = load_model(
            config_path, file_path, use_nsf, self.device)

    @torch.no_grad()
    def spec2wav(self, mel, f0=None, seed: int = 0, randoms=None):
        """mel [T, M] log10-mel -> wav [T*hop] (numpy f32).  The NSF source
        noise comes from ``randoms`` (see generator.draw_randoms) or from a
        generator seeded with ``seed``."""
        mel, f0, t_real = bucket_mel_f0(self.hp, mel, f0)
        c = torch.from_numpy(mel)[None].to(self.device)
        if f0 is not None and self.hp.get("use_nsf"):
            f0_t = torch.from_numpy(np.asarray(f0, np.float32))[None].to(
                self.device)
            if randoms is None:
                g = torch.Generator(device=self.device).manual_seed(int(seed))
                randoms = generator.draw_randoms(
                    1, mel.shape[0] * int(np.prod(self.cfg.upsample_rates)),
                    self.cfg.harmonic_num, g, self.device)
            y = generator.apply_serving(self.gen, c, f0_t, randoms)
        else:
            y = generator.apply_serving(self.gen, c)
        wav_out = y[0].cpu().numpy()
        if mel.shape[0] != t_real:  # bucketed: trim back to the real length
            wav_out = wav_out[: t_real * int(self.hp["hop_size"])]
        if float(self.hp.get("vocoder_denoise_c", 0.0) or 0.0) > 0:
            from .vocoder_utils import denoise

            wav_out = denoise(wav_out, self.hp,
                              v=float(self.hp["vocoder_denoise_c"]),
                              device=self.device)
        return wav_out

    @staticmethod
    def wav2spec(inp_path, hp, device="cpu"):
        """(wav, log10-mel [T, M]) as host numpy: a path or file-like is
        read at the model's rate, an array is taken as is."""
        from ..utils.audio_io import load_wav

        if isinstance(inp_path, (str, os.PathLike)) or hasattr(inp_path,
                                                                "read"):
            wav, _ = load_wav(inp_path, sr=hp["audio_sample_rate"])
        else:
            wav = np.asarray(inp_path, np.float32)
        return mel_ops.wav2spec(wav, hp, device)
