"""Shared HiFi-GAN wrapper helpers.

Counterpart of the part of ``diffsvc_tpu/vocoders/hifigan.py`` the 44.1 kHz
path uses (:func:`bucket_mel_f0`); the 24 kHz ``HifiGAN`` wrapper itself is
not ported yet.
"""

from __future__ import annotations

import numpy as np


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
