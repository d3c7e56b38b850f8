"""Continuous-wavelet f0 decomposition (legacy ``pitch_type: cwt`` path).

A copy of ``diffsvc_tpu/ops/cwt.py`` (numpy only); ``tests/test_torch_standalone.py``
holds it against the original.

Parity target: reference ``utils/cwt.py`` — Mexican-hat CWT of the
continuous log-f0 curve over 10 dyadic scales, plus the inverse transform
and the norm/denorm helpers used by ``cwt2f0``.
"""

from __future__ import annotations

import numpy as np

_dt = 0.005
_dj = 1.0


def _mexican_hat(t, s):
    x = t / s
    return (2.0 / (np.sqrt(3.0) * np.pi**0.25)) * (1 - x**2) * np.exp(-(x**2) / 2)


def get_lf0_cwt(lf0: np.ndarray):
    """CWT over 10 scales: returns (Wavelet_lf0 [T, 10], scales [10]).

    Scale grid matches pycwt (reference utils/cwt.py:58-64): sj = s0 * 2^j
    with s0 = dt*2 = 0.01 s and j = 0..9 -> 0.01 .. 5.12 s."""
    scales = np.array([2.0**i * _dt * 2 for i in range(10)])
    T = len(lf0)
    out = np.zeros((T, len(scales)))
    t = np.arange(T) * _dt
    for j, s in enumerate(scales):
        # convolution with the scaled wavelet, normalized per the standard
        # CWT discretization
        # truncate the wavelet support to the signal length so
        # np.convolve(mode='same') returns T samples (kernel must not be
        # longer than the signal)
        half = min(int(10 * s / _dt), (T - 1) // 2)
        tt = (np.arange(-half, half + 1)) * _dt
        psi = _mexican_hat(tt, s)
        conv = np.convolve(lf0, psi[::-1], mode="same") * _dt
        out[:, j] = conv / np.sqrt(s)
    return out, scales


def norm_scale(Wavelet_lf0: np.ndarray):
    mean = Wavelet_lf0.mean(0)[None, :]
    std = Wavelet_lf0.std(0)[None, :]
    return (Wavelet_lf0 - mean) / np.maximum(std, 1e-8), mean, std


def denormalize(Wavelet_lf0_norm, mean, std):
    return Wavelet_lf0_norm * std + mean


def inverse_cwt(Wavelet_lf0: np.ndarray, scales: np.ndarray):
    """Weighted sum over scales, z-normalized over time (reference
    utils/cwt.py:127-132 — the reconstruction is only defined up to an
    affine transform; the caller rescales with the utterance lf0 stats)."""
    b = ((np.arange(len(scales))[None, :] + 1 + 2.5) ** (-2.5))
    lf0_rec = (Wavelet_lf0 * b).sum(-1)
    mean = lf0_rec.mean(-1, keepdims=True)
    std = np.maximum(lf0_rec.std(-1, keepdims=True), 1e-8)
    return (lf0_rec - mean) / std


def get_cont_lf0(f0: np.ndarray, frame_period: float = 5.0):
    """Continuous log-f0: interpolate over unvoiced, return (uv, cont_lf0)."""
    uv = (f0 == 0).astype(np.float32)
    if (f0 > 0).any():
        voiced = np.where(f0 > 0)[0]
        f0c = np.interp(np.arange(len(f0)), voiced, f0[voiced])
    else:
        f0c = np.ones_like(f0)
    cont_lf0 = np.log(np.maximum(f0c, 1e-8))
    return uv, cont_lf0


def cwt2f0(cwt_spec, mean, std, cwt_scales):
    """Reconstruct f0 from a (possibly predicted) CWT spectrogram.

    Reference utils/cwt.py:137-147: the z-normed inverse reconstruction is
    rescaled with the UTTERANCE-level lf0 mean/std (scalars, or [B] for a
    batched [B, T, 10] cwt_spec), then exponentiated."""
    cwt_spec = np.asarray(cwt_spec)
    lf0 = inverse_cwt(cwt_spec, np.asarray(cwt_scales))
    mean = np.asarray(mean)
    std = np.asarray(std)
    if cwt_spec.ndim == 3:  # [B, T, 10] with mean/std [B]
        lf0 = lf0 * std[:, None] + mean[:, None]
    else:
        lf0 = lf0 * float(std) + float(mean)
    return np.exp(lf0)
