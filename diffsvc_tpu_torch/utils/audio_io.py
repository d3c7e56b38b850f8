"""Host-side audio I/O: WAV read/write, mono mixdown, resampling.

scipy.io.wavfile for container I/O and a polyphase resampler
(scipy.signal.resample_poly) for rate conversion; formats beyond WAV are
gated with a clear error.

The functions of ``diffsvc_tpu/utils/audio_io.py`` that the port calls
(and ``_energy_vad`` / ``trim_long_silences``, the reference's VAD trim),
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


def _energy_vad(pcm_window: np.ndarray, db_threshold: float) -> bool:
    """Per-window voice decision on int16 PCM: RMS gate in dBFS.

    This is the ONE substitution in :func:`trim_long_silences` vs the
    reference: webrtcvad mode 3 (a fixed-point GMM classifier whose model
    tables are not available in this environment) is replaced by an
    energy gate on the same 30 ms / 16 kHz int16 windows. Everything
    around the decision — resample, windowing, smoothing, dilation, mask
    resize — follows the reference arithmetic exactly."""
    x = pcm_window.astype(np.float64) / 32767.0
    rms = np.sqrt((x * x).mean()) if len(x) else 0.0
    return bool(20.0 * np.log10(max(rms, 1e-10)) > db_threshold)


def trim_long_silences(wav: np.ndarray, sr: int,
                       vad_max_silence_length: int = 12,
                       norm: bool = False,
                       vad_fn=None,
                       db_threshold: float = -40.0):
    """Trim silences longer than the VAD dilation window.

    Mirrors reference ``preprocessing/data_gen_utils.py:30-93`` stage by
    stage: (optional) BS.1770 loudness normalization to -20 LUFS with
    peak protection (:41-46, in-repo meter ``ops/loudness.py``); VAD on
    30 ms int16 windows at 16 kHz regardless of the input rate (:47-75);
    width-8 moving-average smoothing with the reference's asymmetric
    zero padding (:76-85); binary dilation by a
    ``ones(vad_max_silence_length + 1)`` structuring element (:87 — for
    the default 12 that is 6 frames each side, NOT 12); then the
    16 kHz sample mask is resized to the raw waveform's length and
    applied to the ORIGINAL-RATE audio (:88-93). The VAD decision
    itself is an energy gate standing in for webrtcvad (see
    :func:`_energy_vad`); pass ``vad_fn(pcm_int16_window) -> bool`` to
    substitute another detector.

    Returns ``(trimmed_wav, mask)`` with ``mask`` over the input-length
    (possibly loudness-normalized) waveform.
    """
    from scipy.ndimage import binary_dilation

    wav_raw = np.asarray(wav, np.float32)
    if norm:
        from ..ops.loudness import normalize_loudness

        wav_raw = normalize_loudness(wav_raw, sr, -20.0)
        peak = float(np.abs(wav_raw).max()) if len(wav_raw) else 0.0
        if peak > 1.0:
            wav_raw = wav_raw / peak

    vad_sr = 16000
    w16 = resample(wav_raw, sr, vad_sr) if sr != vad_sr else wav_raw
    spw = (30 * vad_sr) // 1000  # 30 ms windows (480 samples)
    w16 = w16[: len(w16) - (len(w16) % spw)]
    if not len(w16):
        return wav_raw, np.ones(len(wav_raw), bool)
    pcm = np.round(np.clip(w16, -1.0, 1.0) * 32767).astype(np.int16)
    if vad_fn is None:
        def vad_fn(window):  # noqa: E306
            return _energy_vad(window, db_threshold)
    flags = np.array([vad_fn(pcm[i: i + spw])
                      for i in range(0, len(pcm), spw)], np.float64)

    # moving average width 8, reference padding: (w-1)//2 zeros front,
    # w//2 back (data_gen_utils.py:77-84)
    w = 8
    padded = np.concatenate([np.zeros((w - 1) // 2), flags,
                             np.zeros(w // 2)])
    c = np.cumsum(padded)
    c[w:] = c[w:] - c[:-w]
    mask = np.round(c[w - 1:] / w).astype(bool)

    mask = binary_dilation(mask, np.ones(vad_max_silence_length + 1))
    mask = np.repeat(mask, spw)
    # reference resizes the 16 kHz mask to the raw length (skimage
    # resize > 0); linear interpolation of the float mask is the same
    # operation without the skimage dependency
    if len(mask) != len(wav_raw):
        pos = np.linspace(0.0, len(mask) - 1.0, num=len(wav_raw))
        sample_mask = np.interp(pos, np.arange(len(mask)),
                                mask.astype(np.float64)) > 0
    else:
        sample_mask = mask.astype(bool)
    return wav_raw[sample_mask], sample_mask
