"""Host-side audio I/O: WAV read/write, mono mixdown, resampling.

scipy.io.wavfile for container I/O and a polyphase resampler
(scipy.signal.resample_poly) for rate conversion; formats beyond WAV are
gated with a clear error.

The functions of ``diffsvc_tpu/utils/audio_io.py`` that the port calls,
copied so that the port loads no module of the JAX package.  They read and
write the same samples (int16 PCM is scaled by 1/32768, as that package's
native converter does).
"""

from __future__ import annotations

import io
import os
from typing import Optional, Tuple, Union

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample (kaiser-windowed FIR), float32 output."""
    if orig_sr == target_sr:
        return wav.astype(np.float32)
    g = np.gcd(int(orig_sr), int(target_sr))
    out = resample_poly(wav.astype(np.float64), target_sr // g, orig_sr // g)
    return out.astype(np.float32)


def load_wav(path: Union[str, io.BytesIO], sr: Optional[int] = None,
             mono: bool = True) -> Tuple[np.ndarray, int]:
    """Load a WAV file as float32 in [-1, 1]; optionally resample/mixdown
    (librosa.load semantics, as the reference uses them)."""
    if isinstance(path, (str, os.PathLike)):
        ext = os.path.splitext(str(path))[-1].lower()
        if ext not in (".wav", ""):
            raise ValueError(
                f"Only WAV input is supported in this build (got {ext}); "
                "convert with ffmpeg first.")
    in_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if mono and data.ndim > 1:
        data = data.mean(-1)
    if sr is not None and sr != in_sr:
        data = resample(data, in_sr, sr)
        in_sr = sr
    return data, in_sr


def load_wav_nsf(path: Union[str, io.BytesIO], target_sr: Optional[int] = None
                 ) -> Tuple[np.ndarray, int]:
    """NSF-style loader: first channel (not mixdown) + max-magnitude
    normalization (reference ``modules/nsf_hifigan/nvSTFT.py:14-44``)."""
    in_sr, data = wavfile.read(path)
    if data.ndim > 1:
        data = data[:, 0]
    if np.issubdtype(data.dtype, np.integer):
        max_mag = float(-np.iinfo(data.dtype).min)
    else:
        max_mag = float(max(np.amax(data), -np.amin(data), 0.0))
        max_mag = (2**31) + 1 if max_mag > (2**15) else ((2**15) + 1 if max_mag > 1.01 else 1.0)
    data = data.astype(np.float32) / max_mag
    if target_sr is not None and in_sr != target_sr:
        data = resample(data, in_sr, target_sr)
        in_sr = target_sr
    return data, in_sr


def save_wav(wav: np.ndarray, path: str, sr: int, norm: bool = False) -> None:
    """int16 WAV writer (reference ``utils/audio.py:12-17``)."""
    wav = np.asarray(wav, dtype=np.float32)
    if norm and np.abs(wav).max() > 0:
        wav = wav / np.abs(wav).max()
    wavfile.write(path, sr, (np.clip(wav, -1.0, 1.0) * 32767).astype(np.int16))


def format_wav(in_path: str, out_path: Optional[str] = None) -> str:
    """Ensure a .wav sibling exists for the given audio path."""
    if in_path.lower().endswith(".wav"):
        return in_path
    out_path = out_path or os.path.splitext(in_path)[0] + ".wav"
    if os.path.exists(out_path):
        return out_path
    raise ValueError(
        f"Non-WAV input {in_path}: convert to WAV first (ffmpeg -i in out.wav)")
