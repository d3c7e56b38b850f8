"""HuBERT-soft encoder wrapper: waveform/file -> [T, 256] soft units.

Counterpart of ``diffsvc_tpu/infer/hubert_encoder.py`` (reference
``preprocessing/hubertinfer.py``): loads ``hubert_soft.pt`` (or the first
``*.pt`` under the configured directory), uses a sibling ``.npy`` of a wav
path when one exists, resamples to 16 kHz.  The waveform is zero-padded to
0.4 s multiples and the units trimmed back, exactly like the JAX package,
so the two produce the same units.  ContentVec is not ported yet.
"""

from __future__ import annotations

import io
import os
from pathlib import Path

import numpy as np
import torch

from ..models.hubert import HubertConfig, HubertSoft
from ..utils import convert
from ..utils.audio_io import load_wav

BUCKET = 6400  # 0.4 s at 16 kHz = 20 unit frames


def load(pt_path: str, device="cpu", cfg: HubertConfig = HubertConfig()
         ) -> HubertSoft:
    ckpt = convert.torch_load(pt_path)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    model = HubertSoft(cfg)
    convert.load_reference_state(model, convert.fold_weight_norm(sd))
    return model.to(device).eval()


class Hubertencoder:
    def __init__(self, pt_path: str = "checkpoints/hubert/hubert_soft.pt",
                 hp=None, device="cpu"):
        self.hp = hp or {}
        if self.hp.get("use_vec"):
            raise NotImplementedError("ContentVec (use_vec) is not ported to "
                                      "torch yet")
        self.device = torch.device(device)
        self.model = None
        p = Path(pt_path)
        candidates = [p] if p.is_file() else (
            sorted(p.parent.rglob("*.pt")) if p.parent.exists() else [])
        if candidates:
            self.model = load(str(candidates[0]), self.device)
            print(f"| Loaded HuBERT-soft from {candidates[0]}")
        else:
            print(f"| WARNING: no HuBERT checkpoint under {pt_path}; "
                  "encode() will fail unless .npy sibling features exist.")

    def encode(self, wav_path) -> np.ndarray:
        """wav path / BytesIO / 16 kHz float array -> [T, 256] units."""
        npy_path = ""
        if isinstance(wav_path, io.BytesIO):
            wav_path.seek(0)
        elif isinstance(wav_path, (str, os.PathLike)):
            npy_path = Path(wav_path).with_suffix(".npy")
        if npy_path and os.path.exists(npy_path):
            return np.load(str(npy_path))
        if isinstance(wav_path, np.ndarray):
            wav16k = wav_path  # caller guarantees 16 kHz
        else:
            wav16k, _ = load_wav(wav_path, sr=16000)
        if self.model is None:
            raise FileNotFoundError("HuBERT checkpoint not loaded")
        true_units = max(len(wav16k) // 320, 1)
        pad_len = -(-len(wav16k) // BUCKET) * BUCKET
        wav16k = np.pad(np.asarray(wav16k, np.float32),
                        (0, pad_len - len(wav16k)))
        units = self.model.units(torch.from_numpy(wav16k)[None].to(self.device))
        return units[0, :true_units].float().cpu().numpy()
