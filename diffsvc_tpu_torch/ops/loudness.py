"""ITU-R BS.1770-4 integrated loudness + loudness normalization (mono).

A copy of ``diffsvc_tpu/ops/loudness.py`` (numpy and scipy only), so
that the port loads no module of the JAX package;
``tests/test_torch_standalone.py`` holds it against the original.

Behavior target: the reference normalizes audio with ``pyloudnorm``
(``pyln.Meter(sr).integrated_loudness`` + ``pyln.normalize.loudness``)
in two places — reference ``preprocessing/data_gen_utils.py:41-46``
(``trim_long_silences``, target -20 LUFS) and ``:117-122``
(``process_utterance`` ``loud_norm``, target -22 LUFS). This is the
in-repo equivalent, implemented straight from the BS.1770-4 spec:

- K-weighting pre-filter: stage-1 high shelf + stage-2 high pass,
  designed parametrically for ANY sample rate (the spec tabulates 48 kHz
  only; the parametric form below reproduces the spec's Table 1/2
  coefficients at 48 kHz to float precision — pinned in
  tests/test_loudness.py);
- gated measurement: 400 ms blocks at 75% overlap, -70 LKFS absolute
  gate, then a -10 LU relative gate, integrated over surviving blocks.

Mono only (diff-svc audio is mono); the -0.691 offset makes a 0 dBFS
997-1000 Hz sine read -3.01 LUFS, the spec's calibration point.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

# Parametric K-weighting targets (fit to the BS.1770 48 kHz tables; this
# is the exact parameterization pyloudnorm uses, so any-rate behavior
# matches the reference's meter).
_SHELF_G = 3.999843853973347     # dB
_SHELF_FC = 1681.974450955533    # Hz
_SHELF_Q = 0.7071752369554196
_SHELF_VB_EXP = 0.4996667741545416
_HP_FC = 38.13547087602444       # Hz
_HP_Q = 0.5003270373238773

_ABS_GATE_LUFS = -70.0
_REL_GATE_LU = -10.0
_BLOCK_S = 0.400
_STEP_S = 0.100
_OFFSET = -0.691


def k_weighting_coeffs(sr: int):
    """((shelf_b, shelf_a), (hp_b, hp_a)) biquads at sample rate ``sr``."""
    k = np.tan(np.pi * _SHELF_FC / sr)
    vh = 10.0 ** (_SHELF_G / 20.0)
    vb = vh ** _SHELF_VB_EXP
    d = 1.0 + k / _SHELF_Q + k * k
    shelf_b = np.array([(vh + vb * k / _SHELF_Q + k * k) / d,
                        2.0 * (k * k - vh) / d,
                        (vh - vb * k / _SHELF_Q + k * k) / d])
    shelf_a = np.array([1.0, 2.0 * (k * k - 1.0) / d,
                        (1.0 - k / _SHELF_Q + k * k) / d])
    k = np.tan(np.pi * _HP_FC / sr)
    d = 1.0 + k / _HP_Q + k * k
    hp_b = np.array([1.0, -2.0, 1.0])
    hp_a = np.array([1.0, 2.0 * (k * k - 1.0) / d,
                     (1.0 - k / _HP_Q + k * k) / d])
    return (shelf_b, shelf_a), (hp_b, hp_a)


def integrated_loudness(wav: np.ndarray, sr: int) -> float:
    """Gated integrated loudness in LUFS; ``-inf`` for silence / too-short
    input (< one 400 ms block)."""
    y = np.asarray(wav, np.float64)
    (sb, sa), (hb, ha) = k_weighting_coeffs(sr)
    y = lfilter(hb, ha, lfilter(sb, sa, y))
    block = int(round(_BLOCK_S * sr))
    hop = int(round(_STEP_S * sr))
    if len(y) < block:
        return float("-inf")
    n = 1 + (len(y) - block) // hop
    # mean square per gating block via cumsum (O(N))
    c = np.concatenate([[0.0], np.cumsum(y * y)])
    starts = np.arange(n) * hop
    z = (c[starts + block] - c[starts]) / block
    lblock = _OFFSET + 10.0 * np.log10(np.maximum(z, 1e-30))
    above = lblock > _ABS_GATE_LUFS
    if not above.any():
        return float("-inf")
    gamma_r = (_OFFSET + 10.0 * np.log10(z[above].mean()) + _REL_GATE_LU)
    keep = above & (lblock > gamma_r)
    if not keep.any():
        return float("-inf")
    return float(_OFFSET + 10.0 * np.log10(z[keep].mean()))


def normalize_loudness(wav: np.ndarray, sr: int,
                       target_lufs: float) -> np.ndarray:
    """Gain ``wav`` to ``target_lufs`` (no clipping protection, like
    ``pyln.normalize.loudness`` — reference callers peak-normalize after
    when \\|wav\\| exceeds 1). Unmeasurable input is returned unchanged."""
    loud = integrated_loudness(wav, sr)
    if not np.isfinite(loud):
        return np.asarray(wav, np.float32)
    gain = 10.0 ** ((target_lufs - loud) / 20.0)
    return (np.asarray(wav, np.float64) * gain).astype(np.float32)
