"""Praat-style autocorrelation f0 tracker (Boersma 1993).

Counterpart of ``diffsvc_tpu/ops/f0_ac.py`` (replaces the reference's
parselmouth ``to_pitch_ac(time_step=hop/sr, voicing_threshold=0.6,
pitch_floor=f0_min, pitch_ceiling=f0_max)``):

  1. frames on Praat's midpoint-centred grid,
  2. per-frame normalized autocorrelation via rFFT (r_x / r_window),
  3. candidate peaks with parabolic interpolation + octave cost,
  4. Viterbi path search with Praat's default costs,
  5. voiced frames -> f0 Hz, unvoiced -> 0.

:func:`track` runs all five on the wav's device in one pass, as JAX's
``_track`` does, with JAX's max-plus associative-scan Viterbi
(:func:`_viterbi`); nothing leaves the device before the f0.  The
sequential numpy Viterbi (:func:`_viterbi_seq`) is the plain reference.
Every function takes leading batch dimensions.
"""

from __future__ import annotations

import numpy as np
import torch

from .mel import hann_window_on
from .pitch import f0_to_coarse_np

MAX_CANDIDATES = 15
PERIODS_PER_WINDOW = 3.0
SILENCE_THRESHOLD = 0.03
OCTAVE_COST = 0.01
OCTAVE_JUMP_COST = 0.35
VOICED_UNVOICED_COST = 0.14


def _praat_frame_grid(n_samples: int, sr: float, dt: float,
                      window_len_s: float):
    """Praat Sampled_shortTermAnalysis: number of frames and first centre."""
    duration = n_samples / sr
    n_frames = max(int(np.floor((duration - window_len_s) / dt)) + 1, 1)
    t1 = 0.5 * (duration - (n_frames - 1) * dt)
    return n_frames, t1


def _frame_acf(wav: torch.Tensor, *, hop: int, n_frames: int,
               win_samples: int, fft_size: int, start0: int):
    """Midpoint-centred frames of wav [..., n] -> (r [..., n_frames,
    max_lag+1], local_peak [..., n_frames])."""
    pad_left = max(0, -start0)
    base = start0 + pad_left
    need = (n_frames - 1) * hop + win_samples
    right = max(0, base + need - wav.shape[-1] - pad_left)
    xp = torch.nn.functional.pad(wav, (pad_left, right))
    frames = xp[..., base: base + need].unfold(-1, win_samples, hop)
    frames = frames[..., :n_frames, :]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    local_peak = frames.abs().amax(dim=-1)
    win = hann_window_on(win_samples, wav.device)
    spec = torch.fft.rfft(frames * win, n=fft_size, dim=-1)
    acf = torch.fft.irfft(spec.real ** 2 + spec.imag ** 2, n=fft_size, dim=-1)
    acf = acf / torch.clamp(acf[..., :1], min=1e-12)
    wspec = torch.fft.rfft(win[None, :], n=fft_size, dim=-1)
    wacf = torch.fft.irfft(wspec.real ** 2 + wspec.imag ** 2, n=fft_size,
                           dim=-1)
    wacf = wacf / torch.clamp(wacf[:, :1], min=1e-12)
    max_lag = win_samples // 2
    r = acf[..., : max_lag + 1] / torch.clamp(wacf[..., : max_lag + 1],
                                              min=1e-6)
    return r, local_peak


def _find_candidates(r, local_peak, global_peak, sr, f0_min, f0_max,
                     voicing_threshold):
    """Top-K local maxima of r(tau) [..., n_frames, lags] -> (freq,
    strength) [..., n_frames, K]; candidate 0 is the unvoiced one.
    ``global_peak`` is a tensor broadcasting against ``local_peak``."""
    n_lags = r.shape[-1]
    lag = torch.arange(n_lags, dtype=torch.float32, device=r.device)
    lag_min, lag_max = sr / f0_max, sr / f0_min
    left = torch.cat([r[..., :1], r[..., :-1]], dim=-1)
    right = torch.cat([r[..., 1:], r[..., -1:]], dim=-1)
    is_peak = ((r > left) & (r >= right) & (lag >= max(lag_min, 2.0))
               & (lag <= min(lag_max, n_lags - 2)))
    denom = left - 2.0 * r + right
    delta = torch.where(denom.abs() > 1e-12,
                        0.5 * (left - right) / denom, torch.zeros_like(r))
    delta = torch.clamp(delta, -0.5, 0.5)
    peak_lag = lag + delta
    peak_val = r - 0.25 * (left - right) * delta
    freq = sr / torch.clamp(peak_lag, min=1e-6)
    # Praat reflects normalized-ACF peaks above 1 (r -> 1/r)
    peak_val = torch.where(peak_val > 1.0,
                           1.0 / torch.clamp(peak_val, min=1e-6), peak_val)
    tau_sec = torch.clamp(peak_lag, min=1e-6) / sr
    strength = peak_val - OCTAVE_COST * torch.log2(f0_min * tau_sec)
    strength = torch.where(is_peak, strength,
                           torch.full_like(strength, -float("inf")))
    top_s, top_i = torch.topk(strength, MAX_CANDIDATES - 1, dim=-1)
    top_f = torch.gather(freq, -1, top_i)
    top_r = torch.gather(peak_val, -1, top_i)
    intensity = torch.clamp(local_peak / torch.clamp(global_peak, min=1e-12),
                            max=1.0)
    unvoiced = voicing_threshold + torch.clamp(
        2.0 - intensity / (SILENCE_THRESHOLD / (1.0 + voicing_threshold)),
        min=0.0)
    cand_freq = torch.cat([torch.zeros_like(top_f[..., :1]), top_f], dim=-1)
    cand_strength = torch.cat([unvoiced[..., None], top_s], dim=-1)
    valid = torch.cat([torch.ones_like(top_f[..., :1], dtype=torch.bool),
                       torch.isfinite(top_s) & (top_r > 0.0)], dim=-1)
    cand_strength = torch.where(valid, cand_strength,
                                torch.full_like(cand_strength, -1e9))
    return cand_freq, cand_strength


def _viterbi_seq(cand_freq: np.ndarray, cand_strength: np.ndarray,
                 time_step_correction: float) -> np.ndarray:
    """Sequential max-sum Viterbi over [T, K] candidates in numpy float32
    (JAX's ``_viterbi_scan``): the plain reference of :func:`_viterbi`.
    Ties resolve to the lowest candidate index."""
    f = cand_freq.astype(np.float32)
    s = cand_strength.astype(np.float32)
    voiced = f > 0
    ojc = np.float32(OCTAVE_JUMP_COST * time_step_correction)
    vuc = np.float32(VOICED_UNVOICED_COST * time_step_correction)
    fm = np.maximum(f, np.float32(1e-6))
    n = f.shape[0]
    back = np.zeros(f.shape, np.int64)
    score = s[0]
    for t in range(1, n):
        both = voiced[t - 1][:, None] & voiced[t][None, :]
        jump = np.abs(np.log2(fm[t - 1][:, None] / fm[t][None, :]))
        same = voiced[t - 1][:, None] == voiced[t][None, :]
        cost = np.where(both, ojc * jump,
                        np.where(same, np.float32(0.0), vuc))
        total = score[:, None] - cost + s[t][None, :]
        back[t] = np.argmax(total, axis=0)
        score = total.max(axis=0)
    path = np.zeros(n, np.int64)
    path[-1] = int(np.argmax(score))
    for t in range(n - 1, 0, -1):
        path[t - 1] = back[t, path[t]]
    return path


def _along(dim: int, ndim: int, sl: slice) -> tuple:
    idx = [slice(None)] * ndim
    idx[dim] = sl
    return tuple(idx)


def associative_scan(fn, elems: torch.Tensor, dim: int,
                     reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of an associative ``fn`` along ``dim`` in ~log2(n)
    levels of batched calls: the recursion of ``jax.lax.associative_scan``
    (pairs combined, the half scanned, the even elements filled in), so
    the combines happen in JAX's order.  ``reverse`` scans from the end,
    ``fn`` still receiving the earlier-combined (higher-index) operand
    first, as JAX's does."""
    dim = dim % elems.ndim
    nd = elems.ndim

    def scan(e):
        n = e.shape[dim]
        if n < 2:
            return e
        odd = scan(fn(e[_along(dim, nd, slice(0, n - 1, 2))],
                      e[_along(dim, nd, slice(1, None, 2))]))
        rest = e[_along(dim, nd, slice(2, None, 2))]
        if n % 2 == 0:
            even = fn(odd[_along(dim, nd, slice(0, -1))], rest)
        else:
            even = fn(odd, rest)
        even = torch.cat([e[_along(dim, nd, slice(0, 1))], even], dim=dim)
        k = odd.shape[dim]
        pairs = torch.stack([even[_along(dim, nd, slice(0, k))], odd],
                            dim=dim + 1).flatten(dim, dim + 1)
        if even.shape[dim] > k:
            pairs = torch.cat([pairs, even[_along(dim, nd, slice(k, None))]],
                              dim=dim)
        return pairs

    if reverse:
        return scan(elems.flip(dim)).flip(dim)
    return scan(elems)


def _trans_cost(f_prev, v_prev, f_cur, v_cur, ojc: float, vuc: float):
    both = v_prev & v_cur
    jump = torch.abs(torch.log2(torch.clamp(f_prev, min=1e-6)
                                / torch.clamp(f_cur, min=1e-6)))
    zero = torch.zeros((), dtype=jump.dtype, device=jump.device)
    return torch.where(both, ojc * jump,
                       torch.where(v_prev == v_cur, zero, zero + vuc))


def _maxplus(a, b):
    """(A (x) B)[i, k] = max_j A[i, j] + B[j, k], batched."""
    return (a[..., :, :, None] + b[..., None, :, :]).amax(dim=-2)


def _compose(a, b):
    """Backpointer maps composed: x -> b[a[x]]."""
    return torch.gather(b, -1, a)


def _viterbi(cand_freq: torch.Tensor, cand_strength: torch.Tensor,
             time_step_correction: float) -> torch.Tensor:
    """Viterbi over [..., T, K] candidates as JAX's ``_viterbi``: a max-plus
    associative scan over the [T-1, K, K] transition matrices
    M_t[i, j] = -cost_t(i, j) + s_t[j] gives every frame's forward scores;
    the backpointers (lowest index on ties, the sequential step's formula)
    are composed by a reverse associative scan.  Returns the path
    [..., T] (int64) on the candidates' device."""
    n_frames = cand_freq.shape[-2]
    if n_frames == 1:
        return cand_strength[..., 0, :].argmax(dim=-1)[..., None]
    voiced = cand_freq > 0
    ojc = OCTAVE_JUMP_COST * time_step_correction
    vuc = VOICED_UNVOICED_COST * time_step_correction
    cost = _trans_cost(cand_freq[..., :-1, :, None], voiced[..., :-1, :, None],
                       cand_freq[..., 1:, None, :], voiced[..., 1:, None, :],
                       ojc, vuc)
    m = -cost + cand_strength[..., 1:, None, :]          # [..., T-1, K, K]
    prefix = associative_scan(_maxplus, m, dim=-3)
    scores = (cand_strength[..., :1, :, None] + prefix).amax(dim=-2)
    scores_all = torch.cat([cand_strength[..., :1, :], scores], dim=-2)
    bp = (scores_all[..., :-1, :, None] + m).argmax(dim=-2)   # [..., T-1, K]
    suffix = associative_scan(_compose, bp, dim=-2, reverse=True)
    last = scores_all[..., -1, :].argmax(dim=-1, keepdim=True)   # [..., 1]
    head = torch.gather(suffix, -1, last[..., None, :].expand(
        *suffix.shape[:-1], 1))[..., 0]
    return torch.cat([head, last], dim=-1)


def frame_grid(n_samples: int, sr: int, hop: int, f0_min: float) -> dict:
    """The tracker's static geometry for ``n_samples``: Praat's frame count,
    window, first window start and FFT size."""
    window_len_s = PERIODS_PER_WINDOW / f0_min
    win_samples = int(round(window_len_s * sr))
    n_frames, t1 = _praat_frame_grid(n_samples, sr, hop / sr, window_len_s)
    return dict(n_frames=n_frames, win_samples=win_samples,
                start0=int(round((t1 - window_len_s / 2) * sr)),
                fft_size=int(2 ** np.ceil(np.log2(2 * win_samples))))


def track(wav: torch.Tensor, *, sr: int, hop: int, f0_min: float,
          f0_max: float, voicing_threshold: float = 0.6) -> torch.Tensor:
    """Full tracker in one pass on the wav's device, as JAX's ``_track``:
    ACF -> candidates -> Viterbi -> per-Praat-frame f0 (0 = unvoiced).
    wav [..., n] -> f0 [..., n_frames]; nothing leaves the device."""
    g = frame_grid(wav.shape[-1], sr, hop, f0_min)
    r, local_peak = _frame_acf(wav, hop=hop, **{k: g[k] for k in (
        "n_frames", "win_samples", "fft_size", "start0")})
    global_peak = (wav - wav.mean(dim=-1, keepdim=True)).abs().amax(dim=-1)
    cand_freq, cand_strength = _find_candidates(
        r, local_peak, global_peak[..., None], float(sr), f0_min, f0_max,
        voicing_threshold)
    path = _viterbi(cand_freq, cand_strength, 0.01 / (hop / sr))
    return torch.gather(cand_freq, -1, path[..., None])[..., 0]


def get_pitch_ac(wav: np.ndarray, mel_len: int, hp, device="cpu") -> tuple:
    """parselmouth-compatible entry: (f0 [mel_len] f32, coarse [mel_len]).

    The tracker runs on ``device``.  The wav is zero-padded to a
    ``wav_bucket_frames`` multiple like the JAX package, and the Praat
    track is centred into the mel timeline with
    ``pad = (len(wav)//hop - len(f0) + 1)//2`` (data_gen_utils.py:152-188).
    """
    sr, hop = hp["audio_sample_rate"], hp["hop_size"]
    f0_min, f0_max = float(hp["f0_min"]), float(hp["f0_max"])
    bucket = int(hp.get("wav_bucket_frames", 128) or 1)
    wav = np.asarray(wav, np.float32)
    if bucket > 1:
        pad_len = -(-len(wav) // (bucket * hop)) * (bucket * hop)
        wav = np.pad(wav, (0, pad_len - len(wav)))
    f0 = track(torch.from_numpy(wav).to(device), sr=sr, hop=hop,
               f0_min=f0_min, f0_max=f0_max).cpu().numpy()
    pad_size = (int(len(wav) // hop) - len(f0) + 1) // 2
    rpad = mel_len - len(f0) - pad_size
    if rpad < 0:
        f0 = f0[: len(f0) + rpad]
        rpad = 0
    if pad_size < 0:
        f0 = f0[-pad_size:]
        pad_size = 0
    f0 = np.pad(f0, (pad_size, rpad), mode="constant")[:mel_len]
    return f0.astype(np.float32), f0_to_coarse_np(f0, hp["f0_bin"], f0_min,
                                                  f0_max)
