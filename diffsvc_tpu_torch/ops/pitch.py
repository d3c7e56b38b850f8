"""f0 <-> coarse-bin conversions and log2 normalization.

Counterpart of ``diffsvc_tpu/ops/pitch.py`` (reference
``utils/pitch_utils.py:17-76``).  The torch functions serve the device
conditioner; :func:`norm_interp_f0_np` is the host-side numpy twin used while
building a sample.
"""

from __future__ import annotations

import numpy as np
import torch


def f0_to_coarse(f0: torch.Tensor, f0_bin: int = 256, f0_min: float = 50.0,
                 f0_max: float = 1100.0) -> torch.Tensor:
    """Quantize f0 (Hz) to mel-scale bins in [1, f0_bin-1]; 0 Hz -> bin 1
    (round half to even, as np.rint)."""
    f0_mel_min = 1127.0 * np.log(1 + f0_min / 700.0)
    f0_mel_max = 1127.0 * np.log(1 + f0_max / 700.0)
    f0_mel = 1127.0 * torch.log(1 + f0 / 700.0)
    scaled = (f0_mel - f0_mel_min) * (f0_bin - 2) / (f0_mel_max - f0_mel_min) + 1
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = torch.clamp(f0_mel, 1, f0_bin - 1)
    return torch.round(f0_mel).to(torch.int64)


def f0_to_coarse_np(f0: np.ndarray, f0_bin: int = 256, f0_min: float = 50.0,
                    f0_max: float = 1100.0) -> np.ndarray:
    """numpy twin of :func:`f0_to_coarse` (host-side feature extraction)."""
    f0_mel_min = 1127.0 * np.log(1 + f0_min / 700.0)
    f0_mel_max = 1127.0 * np.log(1 + f0_max / 700.0)
    f0_mel = 1127.0 * np.log(1 + np.asarray(f0) / 700.0)
    scaled = (f0_mel - f0_mel_min) * (f0_bin - 2) / (f0_mel_max - f0_mel_min) + 1
    f0_mel = np.where(f0_mel > 0, scaled, f0_mel)
    return np.rint(np.clip(f0_mel, 1, f0_bin - 1)).astype(int)


def norm_interp_f0_np(f0: np.ndarray, pitch_norm: str = "log",
                      use_uv: bool = False, f0_mean: float = 0.0,
                      f0_std: float = 1.0):
    """log2-normalize then linearly interpolate over unvoiced frames.
    Returns (f0_norm, uv) as float32."""
    f0 = np.asarray(f0, dtype=np.float64)
    uv = f0 == 0
    if pitch_norm == "standard":
        f0 = (f0 - f0_mean) / f0_std
    if pitch_norm == "log":
        with np.errstate(divide="ignore"):
            f0 = np.log2(f0)
    if use_uv:
        f0 = np.where(uv, 0.0, f0)
    if uv.sum() == len(f0):
        f0[uv] = 0.0
    elif uv.sum() > 0:
        f0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], f0[~uv])
    return f0.astype(np.float32), uv.astype(np.float32)


def denorm_f0(f0, uv=None, pitch_norm: str = "log", use_uv: bool = False,
              pitch_padding=None, f0_mean: float = 0.0, f0_std: float = 1.0):
    """Invert the normalization: 2**f0; zero uv/padded positions.  Works on
    torch tensors and numpy arrays alike."""
    if pitch_norm == "standard":
        f0 = f0 * f0_std + f0_mean
    if pitch_norm == "log":
        f0 = 2.0 ** f0
    if isinstance(f0, torch.Tensor):
        zero = torch.zeros((), dtype=f0.dtype, device=f0.device)
        if uv is not None and use_uv:
            f0 = torch.where(uv > 0, zero, f0)
        if pitch_padding is not None:
            f0 = torch.where(pitch_padding, zero, f0)
        return f0
    if uv is not None and use_uv:
        f0 = np.where(uv > 0, 0.0, f0)
    if pitch_padding is not None:
        f0 = np.where(pitch_padding, 0.0, f0)
    return f0


def energy_to_coarse(energy: torch.Tensor) -> torch.Tensor:
    """clamp(energy*256//4, max=255) as int bins (reference fs2.py:240-247)."""
    return torch.clamp(torch.floor_divide(energy * 256, 4), max=255).to(torch.int64)
