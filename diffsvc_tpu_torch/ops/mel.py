"""wav -> log10-mel for both vocoder families.

Counterpart of ``diffsvc_tpu/ops/mel.py`` (``wav2mel_nsf``,
``wav2mel_pwg``, ``stft_mag``, ``mel_filterbank``, ``librosa_pad_lr``,
``wav2spec``):

- **nsf** (44.1 kHz NSF-HiFiGAN), parity target ``nvSTFT.get_mel``: reflect
  pad of (n_fft-hop)/2, no centering, ``sqrt(re^2+im^2+1e-9)``, Slaney
  mel, ``ln(clip(x, 1e-5))``, converted to log10 (``* 0.434294``);
- **pwg** (24 kHz HiFi-GAN), parity target the reference's
  ``process_utterance`` (``data_gen_utils.py:96-149``): centred STFT with
  zero padding, ``|STFT|``, Slaney mel, ``log10(max(eps, mel))``.

Runs on the wav tensor's device (window and filterbank uploaded once per
device), over leading batch dimensions.  ``loud_norm`` normalizes the wav
to -22 LUFS (BS.1770, ``ops/loudness.py``, on the host) before the pwg
mel, as the reference's ``process_utterance`` does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

LOG10_E = 0.4342944819032518  # 1/ln(10)
LN_10 = 2.302585092994046


def hz_to_mel(freq, htk: bool = False):
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz)
                    / logstep, mels)


def mel_to_hz(mels, htk: bool = False):
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@functools.lru_cache(maxsize=16)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
                   htk: bool = False, norm: str = "slaney") -> np.ndarray:
    """Triangular mel filterbank [n_mels, 1+n_fft//2] (librosa-compatible).
    Returns a read-only array: the cache hands the same one to every
    caller."""
    if fmax is None or fmax <= 0:
        fmax = sr / 2.0
    if fmin == -1:
        fmin = 0.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        weights *= (2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels]))[:, None]
    weights = weights.astype(np.float32)
    weights.setflags(write=False)
    return weights


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (scipy fftbins=True / torch.hann_window)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


@functools.lru_cache(maxsize=32)
def hann_window_on(n: int, device: torch.device, n_fft: int = 0
                   ) -> torch.Tensor:
    """:func:`hann_window` on ``device``, zero-padded centred to ``n_fft``
    when that is larger; uploaded once per device (a CUDA graph cannot
    capture the upload)."""
    win = hann_window(n)
    if n_fft > n:
        lp = (n_fft - n) // 2
        win = np.pad(win, (lp, n_fft - n - lp))
    return torch.from_numpy(win).to(device)


def _basis_support(basis: np.ndarray):
    """[first, last+1) rDFT bins with any filterbank weight (the others
    multiply zero, so skipping them is exact)."""
    nz = np.nonzero(basis.sum(axis=0) > 0)[0]
    if len(nz) == 0:
        return 0, basis.shape[1]
    return int(nz[0]), int(nz[-1] + 1)


def stft_mag(y: torch.Tensor, n_fft: int, hop: int, win_length: int,
             mag_eps: float = 0.0, bin_lo: int = 0, bin_hi: int = -1,
             center: bool = False, pad_mode: str = "constant",
             power_floor: float = 0.0) -> torch.Tensor:
    """Magnitude STFT [..., n_frames, bin_hi-bin_lo] of a signal [..., n];
    a win_length window is zero-padded centered in the n_fft frame.
    ``center`` pads n_fft//2 on both sides first (``pad_mode`` "constant"
    or "reflect"); by default the signal is taken as already padded.
    ``mag_eps`` adds to the power before the root, ``power_floor`` clamps
    it from below (parallel_wavegan's STFT loss)."""
    if bin_hi < 0:
        bin_hi = n_fft // 2 + 1
    if center:
        lead = y.shape[:-1]
        y = F.pad(y.reshape(-1, 1, y.shape[-1]), (n_fft // 2, n_fft // 2),
                  mode=pad_mode).reshape(*lead, -1)
    frames = y.unfold(-1, n_fft, hop) * hann_window_on(win_length, y.device,
                                                       n_fft)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)[..., bin_lo:bin_hi]
    power = spec.real ** 2 + spec.imag ** 2
    if mag_eps > 0:
        return torch.sqrt(power + mag_eps)
    if power_floor > 0:
        return torch.sqrt(torch.clamp(power, min=power_floor))
    return torch.sqrt(power)


def wav2mel_nsf(wav: torch.Tensor, *, sr: int, n_fft: int, hop: int,
                win_length: int, n_mels: int, fmin: float, fmax: float,
                clip_val: float = 1e-5) -> torch.Tensor:
    """44.1 kHz NSF-style mel [..., T, n_mels] of wav [..., n] in the
    **log10** domain."""
    pad = (n_fft - hop) // 2
    lead = wav.shape[:-1]
    y = F.pad(wav.float().reshape(-1, 1, wav.shape[-1]), (pad, pad),
              mode="reflect").reshape(*lead, -1)
    b_lo, b_hi, basis_t = _basis_on(sr, n_fft, n_mels, fmin, fmax,
                                    wav.device)
    spc = stft_mag(y, n_fft, hop, win_length, mag_eps=1e-9, bin_lo=b_lo,
                   bin_hi=b_hi)
    mel = spc @ basis_t
    return torch.log(torch.clamp(mel, min=clip_val)) * LOG10_E


@functools.lru_cache(maxsize=16)
def _basis_on(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
              device: torch.device):
    """(first bin, last bin + 1, the filterbank's support transposed
    [bins, n_mels]) on ``device``, uploaded once per device."""
    basis = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    b_lo, b_hi = _basis_support(basis)
    basis_t = torch.from_numpy(np.ascontiguousarray(basis[:, b_lo:b_hi].T))
    return b_lo, b_hi, basis_t.to(device)


def wav2mel_pwg(wav: torch.Tensor, *, sr: int, n_fft: int, hop: int,
                win_length: int, n_mels: int, fmin: float, fmax: float,
                eps: float = 1e-6) -> torch.Tensor:
    """24 kHz 'pwg'-style log10-mel [..., 1 + n // hop, n_mels] of wav
    [..., n]: the STFT centred with n_fft/2 zeros on each side."""
    y = F.pad(wav.float(), (n_fft // 2, n_fft // 2))
    b_lo, b_hi, basis_t = _basis_on(sr, n_fft, n_mels, fmin, fmax,
                                    wav.device)
    spc = stft_mag(y, n_fft, hop, win_length, bin_lo=b_lo, bin_hi=b_hi)
    return torch.log10(torch.clamp(spc @ basis_t, min=eps))


def librosa_pad_lr(x_len: int, fsize: int, fshift: int, pad_sides: int = 1):
    """Padding that makes the wav a hop multiple covering every mel frame
    (reference ``utils/audio.py:38-47``)."""
    assert pad_sides in (1, 2)
    pad = (x_len // fshift + 1) * fshift - x_len
    if pad_sides == 1:
        return 0, pad
    return pad // 2, pad // 2 + pad % 2


def wav2spec(wav: np.ndarray, hp, device="cpu") -> tuple:
    """(wav, mel [T, M]) as host numpy, the mel computed on ``device``,
    dispatched on the configured vocoder family as the reference does
    (``network/vocoders/pwg.py:105-122`` vs ``nsf_hifigan.py:75-92``): the
    nsf mel of the wav as it is, or the pwg mel and the wav padded to a
    hop multiple and cut to the mel's frames."""
    wav = np.ascontiguousarray(wav, dtype=np.float32)
    geo = dict(sr=hp["audio_sample_rate"], n_fft=hp["fft_size"],
               hop=hp["hop_size"], win_length=hp["win_size"],
               n_mels=hp["audio_num_mel_bins"], fmin=float(hp["fmin"]),
               fmax=float(hp["fmax"]))
    x = torch.from_numpy(wav).to(device)
    if "nsf" in str(hp.get("vocoder", "")).lower():
        return wav, wav2mel_nsf(x, **geo).cpu().numpy()
    if hp.get("loud_norm"):
        # the reference's process_utterance loud_norm: -22 LUFS, then the
        # peak brought to 1 when above (data_gen_utils.py:117-122)
        from .loudness import normalize_loudness

        wav = normalize_loudness(wav, hp["audio_sample_rate"], -22.0)
        if len(wav) and np.abs(wav).max() > 1.0:
            wav = wav / np.abs(wav).max()
        x = torch.from_numpy(wav).to(device)
    mel = wav2mel_pwg(x, eps=float(hp.get("wav2spec_eps", 1e-6)), **geo)
    mel = mel.cpu().numpy()
    l_pad, r_pad = librosa_pad_lr(len(wav), hp["fft_size"], hp["hop_size"])
    wav_out = np.pad(wav, (l_pad, r_pad))[: mel.shape[0] * hp["hop_size"]]
    return wav_out, mel
