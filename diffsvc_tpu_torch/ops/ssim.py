"""Gaussian-window SSIM on mel 'images' (reference modules/commons/ssim.py,
used by the FastSpeech2 mel_loss 'ssim' term).

Counterpart of ``diffsvc_tpu/ops/ssim.py``: an 11x11 Gaussian window
(sigma 1.5), a depthwise 2-D convolution with zero SAME padding over
[B, T, M] (``F.conv2d``), C1 = 0.01^2, C2 = 0.03^2.  A loss term, not a
kernel of the port.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=4)
def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2.0 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter2d(x: torch.Tensor, window: np.ndarray) -> torch.Tensor:
    """The window over [B, T, M] with zero SAME padding."""
    k = window.shape[0]
    w = torch.from_numpy(window).to(x.device, x.dtype)[None, None]
    return F.conv2d(x[:, None], w, padding=k // 2)[:, 0]


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """img1/img2: [B, T, M]; the mean SSIM, or the map with
    ``size_average=False``."""
    window = _gaussian_window(window_size)
    mu1 = _filter2d(img1, window)
    mu2 = _filter2d(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = _filter2d(img1 * img1, window) - mu1_sq
    sigma2_sq = _filter2d(img2 * img2, window) - mu2_sq
    sigma12 = _filter2d(img1 * img2, window) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / \
        ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if size_average:
        return ssim_map.mean()
    return ssim_map
