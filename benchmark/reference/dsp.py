"""The front end's signal processing, plainly: polyphase resampling
(scipy), Praat's autocorrelation f0 tracker with a sequential Viterbi, the
uniform unit alignment and the f0 normalization.  The input's mel feeds
only the energy and ground-truth paths, which these configurations leave
off, so the reference computes none.  Torch parts run in f32 on the
caller's device; the path search and the alignment run on the host.

Frozen from the published algorithms as diff-svc uses them; the
constants of the tracker are Praat's defaults (``to_pitch_ac`` with
voicing threshold 0.6).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.signal import resample_poly

LN_10 = 2.302585092994046


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """scipy.signal.resample_poly in float64, float32 out."""
    if orig_sr == target_sr:
        return np.asarray(wav, np.float32)
    g = math.gcd(int(orig_sr), int(target_sr))
    return resample_poly(np.asarray(wav, np.float64), target_sr // g,
                         orig_sr // g).astype(np.float32)


def hann(n: int) -> np.ndarray:
    """Periodic Hann window."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
            ).astype(np.float32)


# ------------------------------------------------------------- f0 tracker

MAX_CANDIDATES = 15
PERIODS_PER_WINDOW = 3.0
SILENCE_THRESHOLD = 0.03
OCTAVE_COST = 0.01
OCTAVE_JUMP_COST = 0.35
VOICED_UNVOICED_COST = 0.14


def frame_grid(n_samples: int, sr: int, hop: int, f0_min: float) -> dict:
    """Praat's short-term analysis grid: frame count, window, first window
    start and the FFT size of the autocorrelation."""
    window_len_s = PERIODS_PER_WINDOW / f0_min
    win = int(round(window_len_s * sr))
    duration, dt = n_samples / sr, hop / sr
    n_frames = max(int(np.floor((duration - window_len_s) / dt)) + 1, 1)
    t1 = 0.5 * (duration - (n_frames - 1) * dt)
    return dict(n_frames=n_frames, win=win,
                start0=int(round((t1 - window_len_s / 2) * sr)),
                fft=int(2 ** np.ceil(np.log2(2 * win))))


def _candidates(wav: torch.Tensor, sr: int, hop: int, f0_min: float,
                f0_max: float, voicing: float = 0.6):
    """Per frame: the unvoiced candidate and the 14 strongest
    autocorrelation peaks (parabolic interpolation, octave cost), as
    (freq, strength) [T, 15]."""
    g = frame_grid(wav.shape[-1], sr, hop, f0_min)
    n_frames, win, start0, n_fft = g["n_frames"], g["win"], g["start0"], \
        g["fft"]
    pad_left = max(0, -start0)
    need = (n_frames - 1) * hop + win
    base = start0 + pad_left
    right = max(0, base + need - wav.shape[-1] - pad_left)
    xp = torch.nn.functional.pad(wav, (pad_left, right))
    frames = xp[base: base + need].unfold(-1, win, hop)[:n_frames]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    local_peak = frames.abs().amax(dim=-1)
    w = torch.from_numpy(hann(win)).to(wav.device)

    def acf(x):
        s = torch.fft.rfft(x, n=n_fft, dim=-1)
        r = torch.fft.irfft(s.real ** 2 + s.imag ** 2, n=n_fft, dim=-1)
        return r / torch.clamp(r[..., :1], min=1e-12)

    max_lag = win // 2
    r = acf(frames * w)[..., : max_lag + 1] / torch.clamp(
        acf(w[None])[..., : max_lag + 1], min=1e-6)
    n_lags = r.shape[-1]
    lag = torch.arange(n_lags, dtype=torch.float32, device=r.device)
    left = torch.cat([r[..., :1], r[..., :-1]], dim=-1)
    right = torch.cat([r[..., 1:], r[..., -1:]], dim=-1)
    is_peak = ((r > left) & (r >= right) & (lag >= max(sr / f0_max, 2.0))
               & (lag <= min(sr / f0_min, n_lags - 2)))
    denom = left - 2.0 * r + right
    delta = torch.clamp(torch.where(denom.abs() > 1e-12,
                                    0.5 * (left - right) / denom,
                                    torch.zeros_like(r)), -0.5, 0.5)
    peak_lag = torch.clamp(lag + delta, min=1e-6)
    peak_val = r - 0.25 * (left - right) * delta
    peak_val = torch.where(peak_val > 1.0,
                           1.0 / torch.clamp(peak_val, min=1e-6), peak_val)
    strength = peak_val - OCTAVE_COST * torch.log2(f0_min * peak_lag / sr)
    strength = torch.where(is_peak, strength,
                           torch.full_like(strength, -float("inf")))
    top_s, top_i = torch.topk(strength, MAX_CANDIDATES - 1, dim=-1)
    top_f = torch.gather(sr / peak_lag, -1, top_i)
    top_r = torch.gather(peak_val, -1, top_i)
    global_peak = (wav - wav.mean()).abs().amax()
    intensity = torch.clamp(local_peak / torch.clamp(global_peak, min=1e-12),
                            max=1.0)
    unvoiced = voicing + torch.clamp(
        2.0 - intensity / (SILENCE_THRESHOLD / (1.0 + voicing)), min=0.0)
    freq = torch.cat([torch.zeros_like(top_f[..., :1]), top_f], dim=-1)
    strength = torch.cat([unvoiced[..., None], top_s], dim=-1)
    valid = torch.cat([torch.ones_like(top_f[..., :1], dtype=torch.bool),
                       torch.isfinite(top_s) & (top_r > 0.0)], dim=-1)
    strength = torch.where(valid, strength, torch.full_like(strength, -1e9))
    return freq, strength


def _viterbi(freq: np.ndarray, strength: np.ndarray, correction: float):
    """Sequential max-sum path over [T, K] candidates (float32; ties to the
    lowest index) with Praat's octave-jump and voicing-transition costs."""
    f, s = freq.astype(np.float32), strength.astype(np.float32)
    voiced = f > 0
    ojc = np.float32(OCTAVE_JUMP_COST * correction)
    vuc = np.float32(VOICED_UNVOICED_COST * correction)
    fm = np.maximum(f, np.float32(1e-6))
    n = f.shape[0]
    back = np.zeros(f.shape, np.int64)
    score = s[0]
    for t in range(1, n):
        both = voiced[t - 1][:, None] & voiced[t][None, :]
        jump = np.abs(np.log2(fm[t - 1][:, None] / fm[t][None, :]))
        same = voiced[t - 1][:, None] == voiced[t][None, :]
        cost = np.where(both, ojc * jump, np.where(same, np.float32(0.0), vuc))
        total = score[:, None] - cost + s[t][None, :]
        back[t] = np.argmax(total, axis=0)
        score = total.max(axis=0)
    path = np.zeros(n, np.int64)
    path[-1] = int(np.argmax(score))
    for t in range(n - 1, 0, -1):
        path[t - 1] = back[t, path[t]]
    return path


def track_f0(wav: torch.Tensor, sr: int, hop: int, f0_min: float,
             f0_max: float) -> np.ndarray:
    """f0 (Hz, 0 unvoiced) per Praat frame of ``wav`` [n]."""
    freq, strength = _candidates(wav.float(), sr, hop, f0_min, f0_max)
    freq, strength = freq.cpu().numpy(), strength.cpu().numpy()
    path = _viterbi(freq, strength, 0.01 / (hop / sr))
    return freq[np.arange(len(path)), path]


# ------------------------------------------------------ alignment and f0

def align_uniform(mel_len: int, n_units: int) -> np.ndarray:
    """Frame f -> unit j + 1 of the first unit whose span (mel_len /
    n_units frames, ends rounded) ends at or after f."""
    ph = mel_len / n_units
    end = np.floor(np.arange(n_units) * ph + ph + 0.5).astype(np.int64)
    j = np.searchsorted(end, np.arange(mel_len), side="left")
    return np.clip(j + 1, 1, n_units)


def norm_interp_f0(f0: np.ndarray):
    """(log2 f0 with unvoiced frames interpolated linearly between voiced
    neighbours and held flat past the ends, uv) float32; all zeros when no
    frame is voiced."""
    f0 = np.asarray(f0, np.float64)
    uv = f0 == 0
    out = np.zeros_like(f0)
    if (~uv).any():
        lf = np.log2(f0[~uv])
        out = np.interp(np.arange(len(f0)), np.where(~uv)[0], lf)
    return out.astype(np.float32), uv.astype(np.float32)


def f0_to_coarse(f0: torch.Tensor, f0_bin=256, f0_min=50.0, f0_max=1100.0):
    """Mel-scale pitch bins in [1, f0_bin - 1] (round half to even)."""
    lo = 1127.0 * np.log(1 + f0_min / 700.0)
    hi = 1127.0 * np.log(1 + f0_max / 700.0)
    m = 1127.0 * torch.log(1 + f0 / 700.0)
    m = torch.where(m > 0, (m - lo) * (f0_bin - 2) / (hi - lo) + 1, m)
    return torch.round(torch.clamp(m, 1, f0_bin - 1)).long()
