"""44.1 kHz NSF-HiFiGAN vocoder wrapper.

Counterpart of ``diffsvc_tpu/vocoders/nsf_hifigan.py`` (reference
``network/vocoders/nsf_hifigan.py``): loads an openvpi checkpoint (sibling
``config.json`` + ``generator`` state dict, weight norm folded), warns on
config mismatches, converts log10-mel -> ln-mel (* ln 10) before the
generator, and its ``wav2spec`` is the nvSTFT mel in log10.  Synthesis runs
:func:`generator.apply_serving` (K3 on a CUDA device).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops import mel as mel_ops
from ..utils import convert
from ..utils.audio_io import load_wav_nsf
from . import generator
from .base import BaseVocoder, register_vocoder
from .hifigan import bucket_mel_f0


def load_model(model_path: str, device="cpu"):
    config_file = os.path.join(os.path.split(model_path)[0], "config.json")
    with open(config_file, encoding="utf-8") as f:
        h = json.load(f)
    ckpt = convert.torch_load(model_path)
    cfg = generator.HifiGanConfig.from_dict(h, use_nsf=True)
    gen = generator.Generator(cfg)
    convert.load_reference_state(gen, convert.fold_weight_norm(ckpt["generator"]))
    print(f"| Loaded NSF-HiFiGAN from {model_path}")
    return gen.to(device).eval(), cfg, h


@register_vocoder
class NsfHifiGAN(BaseVocoder):
    def __init__(self, hp, device="cpu"):
        self.hp = hp
        self.device = torch.device(device)
        self.gen = None
        model_path = hp["vocoder_ckpt"]
        if os.path.exists(model_path):
            self.gen, self.cfg, self.h = load_model(model_path, self.device)
            self._check_params()
        else:
            print("Error: NSF-HiFiGAN model file is not found!")

    def _check_params(self):
        pairs = [("sampling_rate", "audio_sample_rate"),
                 ("num_mels", "audio_num_mel_bins"), ("n_fft", "fft_size"),
                 ("win_size", "win_size"), ("hop_size", "hop_size"),
                 ("fmin", "fmin"), ("fmax", "fmax")]
        for hk, pk in pairs:
            if hk in self.h and self.h[hk] != self.hp.get(pk):
                print(f"Mismatch parameters: hparams['{pk}']={self.hp.get(pk)}"
                      f" != {self.h[hk]} (vocoder)")

    @torch.no_grad()
    def spec2wav(self, mel, f0=None, seed: int = 0, randoms=None):
        """mel [T, M] log10-mel -> wav [T*hop] (numpy f32).  The NSF source
        noise comes from ``randoms`` (see generator.draw_randoms) or from a
        generator seeded with ``seed``."""
        if self.gen is None:
            raise FileNotFoundError("NSF-HiFiGAN checkpoint not loaded")
        mel, f0, t_real = bucket_mel_f0(self.hp, mel, f0)
        c = torch.from_numpy(mel)[None].to(self.device) * mel_ops.LN_10
        if f0 is not None and self.hp.get("use_nsf"):
            f0_t = torch.from_numpy(np.asarray(f0, np.float32))[None].to(self.device)
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
        return wav_out

    @staticmethod
    def wav2spec(inp_path, hp, device="cpu"):
        """(wav numpy f32, log10-mel [T, M] numpy f32); a path or file-like
        is read with the NSF loader, an array is taken as is."""
        if isinstance(inp_path, (str, os.PathLike)) or hasattr(inp_path, "read"):
            wav, _ = load_wav_nsf(inp_path, target_sr=hp["audio_sample_rate"])
        else:
            wav = np.asarray(inp_path, np.float32)
        mel = mel_ops.wav2mel_nsf(
            torch.from_numpy(np.ascontiguousarray(wav)).to(device),
            sr=hp["audio_sample_rate"], n_fft=hp["fft_size"],
            hop=hp["hop_size"], win_length=hp["win_size"],
            n_mels=hp["audio_num_mel_bins"], fmin=float(hp["fmin"]),
            fmax=float(hp["fmax"]))
        return wav, mel.cpu().numpy()
