"""Spectral-subtraction denoise of vocoder output.

Counterpart of ``diffsvc_tpu/vocoders/vocoder_utils.py`` (reference
``network/vocoders/vocoder_utils.py:7-15``): STFT (on ``device``), the
magnitude less ``v`` floored at 0 with the phase kept, iSTFT by
window-square-normalized overlap-add (host float64).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.mel import hann_window_on


def denoise(wav: np.ndarray, hp, v: float = 0.1, device="cpu") -> np.ndarray:
    n_fft, hop, win = hp["fft_size"], hp["hop_size"], hp["win_size"]
    y = F.pad(torch.as_tensor(np.asarray(wav, np.float32), device=device),
              (n_fft // 2, n_fft // 2))
    w = hann_window_on(win, torch.device(device), n_fft)
    spec = torch.fft.rfft(y.unfold(-1, n_fft, hop) * w, n=n_fft, dim=-1)
    spec = torch.polar(torch.clamp(spec.abs() - v, min=0.0), spec.angle())
    fr = (torch.fft.irfft(spec, n=n_fft, dim=-1) * w).cpu().numpy()
    n = fr.shape[0]
    out = np.zeros(n_fft + (n - 1) * hop, np.float64)
    norm = np.zeros_like(out)
    w2 = w.double().cpu().numpy() ** 2
    for i in range(n):
        out[i * hop: i * hop + n_fft] += fr[i]
        norm[i * hop: i * hop + n_fft] += w2
    out = out / np.maximum(norm, 1e-8)
    return out[n_fft // 2: n_fft // 2 + len(wav)].astype(np.float32)
