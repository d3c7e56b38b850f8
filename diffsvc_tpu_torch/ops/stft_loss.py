"""Multi-resolution STFT loss (vocoder training).

Counterpart of ``diffsvc_tpu/ops/stft_loss.py:15-52`` (parallel_wavegan's
``losses/stft_loss.py``): spectral convergence + log-magnitude L1 at three
resolutions (1024/120/600, 2048/240/1200, 512/50/240), each on a
reflect-centred STFT with the power clamped at 1e-7 before the root.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .mel import stft_mag

DEFAULT_RESOLUTIONS: Tuple[Tuple[int, int, int], ...] = (
    (1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def spectral_convergence(mag_pred, mag_gt):
    return torch.linalg.norm(mag_gt - mag_pred) / torch.clamp(
        torch.linalg.norm(mag_gt), min=1e-9)


def log_stft_magnitude(mag_pred, mag_gt):
    return torch.abs(torch.log(torch.clamp(mag_gt, min=1e-7))
                     - torch.log(torch.clamp(mag_pred, min=1e-7))).mean()


def stft_loss(y_pred, y_gt, fft_size: int, hop: int, win: int):
    mp, mg = (stft_mag(y, fft_size, hop, win, center=True,
                       pad_mode="reflect", power_floor=1e-7)
              for y in (y_pred, y_gt))
    return spectral_convergence(mp, mg), log_stft_magnitude(mp, mg)


def multi_resolution_stft_loss(
        y_pred, y_gt,
        resolutions: Sequence[Tuple[int, int, int]] = DEFAULT_RESOLUTIONS):
    """y_pred / y_gt [T] waveforms -> (sc loss, mag loss), each averaged
    over the resolutions."""
    sc_total, mag_total = 0.0, 0.0
    for fft_size, hop, win in resolutions:
        sc, mag = stft_loss(y_pred, y_gt, fft_size, hop, win)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(resolutions)
    return sc_total / n, mag_total / n
