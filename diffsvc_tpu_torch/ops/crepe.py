"""CREPE pitch tracker ('full' capacity) on the tracker's device.

Counterpart of ``diffsvc_tpu/ops/crepe.py`` (reference
``preprocessing/data_gen_utils.py:191-230`` through torchcrepe): 16 kHz
input, hop 80 (5 ms), centred 1024-sample z-scored frames -> six conv
layers (relu, BatchNorm, max-pool 2) -> 2048 -> sigmoid over 360 pitch bins
(20 cents apart from 32.70 Hz) -> Viterbi decode with weighted-average
cents -> the reference's filter chain: median(periodicity, 3), the -60 dB
A-weighted silence gate, the periodicity threshold, the NaN-aware mean(f0,
3), NaN -> 0, and linear interpolation of voiced f0 onto the mel frames.

:class:`Crepe` keeps torchcrepe's state-dict names and layouts
(``conv1..conv6`` as [out, in, k, 1] Conv2d, ``conv{i}_BN``,
``classifier``), so a torchcrepe ``full.pth`` loads directly; BatchNorm
runs at eps 1e-5, as the JAX package's forward does.  The frames, the
network (cuDNN convolutions in true f32, each algorithm chosen by cuDNN's
benchmark: with the card's memory free, its heuristic picks algorithms
that take ~10x as long and ~56 GiB of workspace on the H100,
``tools/crepe_variants.py``; every call has one shape, ``FRAME_CHUNK``
frames, so the benchmark runs once per process) and the Viterbi
recursion run on the wav's device; the Viterbi is one max-plus step per frame over the
360 x 360 log-transition table (frames in order: a sequential recursion
of ~3 launches per frame on the card), its back-pointers come to the host
once and the path is traced back there.  The loudness gate, the filters
and the interpolation are host numpy, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.nn import true_f32_convs
from .pitch import f0_to_coarse_np

SR = 16000
HOP = 80
WINDOW = 1024
N_BINS = 360
CENTS_PER_BIN = 20.0
CENTS_OFFSET = 1997.3794084376191

# 'full' capacity
FILTERS = [1024, 128, 128, 128, 256, 512]
KERNELS = [512, 64, 64, 64, 64, 64]
STRIDES = [4, 1, 1, 1, 1, 1]
BN_EPS = 1e-5
FRAME_CHUNK = 512       # frames per network call (conv1's output is ~1 MB
                        # a frame); a shorter last call is padded to it

_model_cache: Dict[tuple, "Crepe"] = {}


class Crepe(nn.Module):
    """The 'full' network; ``forward`` maps z-scored frames [N, 1024] to
    posteriors [N, 360]."""

    def __init__(self):
        super().__init__()
        c_in = 1
        for i, (f, k, s) in enumerate(zip(FILTERS, KERNELS, STRIDES), 1):
            setattr(self, f"conv{i}", nn.Conv2d(c_in, f, (k, 1), (s, 1)))
            setattr(self, f"conv{i}_BN", nn.BatchNorm2d(f, eps=BN_EPS))
            c_in = f
        self.classifier = nn.Linear(2048, N_BINS)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames[:, None, :, None]
        with true_f32_convs():
            for i, (k, s) in enumerate(zip(KERNELS, STRIDES), 1):
                # torchcrepe's 'same' zero padding: (254, 254) for the k=512
                # s=4 layer, (31, 32), low side first, for the k=64 ones
                lo = (k - s) // 2 if s > 1 else (k - 1) // 2
                hi = k - s - lo if s > 1 else k // 2
                x = getattr(self, f"conv{i}")(F.pad(x, (0, 0, lo, hi)))
                x = getattr(self, f"conv{i}_BN")(F.relu(x))
                x = F.max_pool2d(x, (2, 1), (2, 1))
        # time-major flatten (t * C + c), torchcrepe's permute + reshape
        x = x.permute(0, 2, 1, 3).reshape(x.shape[0], -1)
        return torch.sigmoid(self.classifier(x))


def bins_to_cents(bins):
    return CENTS_PER_BIN * bins + CENTS_OFFSET


def cents_to_frequency(cents):
    return 10.0 * 2 ** (cents / 1200.0)


def frame_audio(wav16k: torch.Tensor, hop: int = HOP) -> torch.Tensor:
    """Centred 1024-sample frames every ``hop`` samples, z-scored per frame
    (on the wav's device): [1 + len // hop, 1024]."""
    n_frames = 1 + wav16k.shape[-1] // hop
    w = F.pad(wav16k.float(), (WINDOW // 2, WINDOW // 2))
    frames = w.unfold(-1, WINDOW, hop)[:n_frames]
    mean = frames.mean(dim=1, keepdim=True)
    std = frames.std(dim=1, unbiased=False, keepdim=True).clamp_min(1e-10)
    return (frames - mean) / std


@contextlib.contextmanager
def cudnn_benchmark():
    """cuDNN's algorithms chosen by timing them (once per shape) inside the
    block; the caller's ``torch.backends.cudnn.benchmark`` is restored."""
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = prev


def posteriors(model: Crepe, frames: torch.Tensor) -> torch.Tensor:
    """The network over all frames, ``FRAME_CHUNK`` at a time (the last
    call padded with zero frames to ``FRAME_CHUNK``; frames do not mix, so
    the padding changes no real frame's posteriors)."""
    out = []
    with torch.no_grad(), cudnn_benchmark():
        for i in range(0, frames.shape[0], FRAME_CHUNK):
            chunk = frames[i: i + FRAME_CHUNK]
            n = chunk.shape[0]
            out.append(model(F.pad(chunk, (0, 0, 0, FRAME_CHUNK - n)))[:n])
    return torch.cat(out)


def a_weighting_db(freqs: np.ndarray, min_db: float = -80.0) -> np.ndarray:
    """IEC 61672 A-weighting curve in dB (0 dB at 1 kHz)."""
    f_sq = np.asarray(freqs, np.float64) ** 2
    const = np.array([12194.217, 20.598997, 107.65265, 737.86223]) ** 2
    with np.errstate(divide="ignore"):
        w = 2.0 + 20.0 * (
            np.log10(const[0]) + 2 * np.log10(np.maximum(f_sq, 0))
            - np.log10(f_sq + const[0]) - np.log10(f_sq + const[1])
            - 0.5 * np.log10(f_sq + const[2]) - 0.5 * np.log10(f_sq + const[3]))
    return np.maximum(w, min_db)


_A_REF_DB = 20.0    # torchcrepe loudness.REF_DB
_A_MIN_DB = -100.0  # torchcrepe loudness.MIN_DB


def a_weighted_loudness(wav16k: np.ndarray, hop: int = HOP,
                        n_fft: int = WINDOW) -> np.ndarray:
    """Per-frame A-weighted loudness (torchcrepe loudness.a_weighted):
    centred zero-padded periodic-Hann STFT, amplitude in dB (amin 1e-5,
    80 dB below the global peak), + A-weighting - 20 dB, floor -100 dB,
    mean over bins.  Host numpy in float64."""
    pad = n_fft // 2
    w = np.pad(np.asarray(wav16k, np.float64), (pad, pad))
    n_frames = 1 + len(wav16k) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    mag = np.abs(np.fft.rfft(w[idx] * hann, axis=1))
    db = 20.0 * np.log10(np.maximum(mag, 1e-5))
    db = np.maximum(db, db.max() - 80.0)
    freqs = np.fft.rfftfreq(n_fft, d=1.0 / SR)
    weighted = db + (a_weighting_db(freqs) - _A_REF_DB)[None, :]
    return np.maximum(weighted, _A_MIN_DB).mean(axis=1).astype(np.float32)


def _viterbi(probs: torch.Tensor, transition_width: int = 12
             ) -> torch.Tensor:
    """Max-product decode over the bins (librosa's viterbi as torchcrepe
    calls it): softmax observations, the band-limited transition prior,
    a uniform start.  The recursion runs on probs' device; the path is
    traced back on the host.  Returns bins [N] (int64, probs' device)."""
    n_frames, n = probs.shape
    dev = probs.device
    i = torch.arange(n, device=dev)
    d = (i[:, None] - i[None, :]).abs()
    trans = torch.clamp(transition_width - d, min=0).float()
    trans = trans / trans.sum(dim=1, keepdim=True)
    log_trans = torch.log(torch.clamp(trans, min=1e-12))
    log_obs = torch.log_softmax(probs.float(), dim=1)
    score = log_obs[0] - float(np.log(n))
    back = torch.empty((max(n_frames - 1, 0), n), dtype=torch.int64,
                       device=dev)
    for t in range(1, n_frames):
        best, back[t - 1] = torch.max(score[:, None] + log_trans, dim=0)
        score = best + log_obs[t]
    back_np = back.cpu().numpy()
    path = np.empty(n_frames, np.int64)
    path[-1] = int(torch.argmax(score))
    for t in range(n_frames - 2, -1, -1):
        path[t] = back_np[t, path[t + 1]]
    return torch.from_numpy(path).to(dev)


def decode(probs: torch.Tensor):
    """probs [N, 360] -> (f0 Hz [N], periodicity [N]) on probs' device:
    Viterbi bins, then the weighted-average cents of a +-4-bin window."""
    bins = _viterbi(probs)
    n = probs.shape[1]
    offs = torch.arange(-4, 5, device=probs.device)
    idx = torch.clamp(bins[:, None] + offs[None, :], 0, n - 1)
    w = torch.gather(probs, 1, idx)
    cents = bins_to_cents(idx.float())
    avg = (w * cents).sum(1) / torch.clamp(w.sum(1), min=1e-9)
    f0 = cents_to_frequency(avg)
    return f0, torch.gather(probs, 1, bins[:, None])[:, 0]


def median_filter(x: np.ndarray, win: int = 3):
    """torchcrepe filter.median: NaN-aware sliding median, NaN edges."""
    half = win // 2
    xp = np.concatenate([np.full(half, np.nan), np.asarray(x, np.float64),
                         np.full(half, np.nan)])
    sw = np.lib.stride_tricks.sliding_window_view(xp, win)
    with np.errstate(all="ignore"):
        return np.nanmedian(sw, axis=1)


def mean_filter(x: np.ndarray, win: int = 3):
    """torchcrepe filter.mean: NaN-aware windowed mean (NaNs are missing,
    all-NaN windows stay NaN)."""
    half = win // 2
    xp = np.concatenate([np.full(half, np.nan), np.asarray(x, np.float64),
                         np.full(half, np.nan)])
    valid = ~np.isnan(xp)
    vals = np.where(valid, xp, 0.0)
    k = np.ones(win)
    ksum = np.convolve(vals, k, mode="valid")
    kcnt = np.convolve(valid.astype(np.float64), k, mode="valid")
    return np.where(kcnt > 0, ksum / np.maximum(kcnt, 1.0), np.nan)


def load_crepe(path: str, device="cpu") -> Crepe:
    """A torchcrepe 'full' state dict as a :class:`Crepe` on ``device``
    (kept per path and device)."""
    key = (os.path.abspath(path), str(torch.device(device)))
    if key not in _model_cache:
        from ..utils.convert import torch_load

        model = Crepe()
        model.load_state_dict(torch_load(path))
        _model_cache[key] = model.to(device).eval()
    return _model_cache[key]


def get_pitch_crepe(wav: np.ndarray, mel: np.ndarray, hp, threshold=0.05,
                    model: Optional[Crepe] = None, device="cpu"):
    """The reference chain's CREPE f0 on the mel grid: (f0 [T_mel] f32,
    coarse [T_mel]).  Without ``model`` the weights come from
    ``crepe_path``; a missing file raises FileNotFoundError."""
    from ..utils.audio_io import resample

    if model is None:
        path = hp.get("crepe_path", "checkpoints/crepe/full.pth")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no crepe weights at {path}")
        model = load_crepe(path, device)
    dev = next(model.parameters()).device
    wav16k = resample(np.asarray(wav, np.float32), hp["audio_sample_rate"],
                      SR)
    probs = posteriors(model, frame_audio(torch.from_numpy(wav16k).to(dev)))
    f0, pd = (a.double().cpu().numpy() for a in decode(probs))

    pd = median_filter(pd, 3)
    pd[a_weighted_loudness(wav16k)[: len(pd)] < -60.0] = 0.0
    f0 = np.where(pd < threshold, np.nan, f0)
    f0 = mean_filter(f0, 3)
    f0 = np.where(np.isnan(f0), 0.0, f0).astype(np.float32)

    # voiced f0 interpolated onto the mel frame times (5 ms grid -> hop)
    nz = np.nonzero(f0)[0]
    time_frame = np.arange(len(mel)) * hp["hop_size"] / hp["audio_sample_rate"]
    if len(nz) == 0:
        out = np.zeros(len(mel), np.float32)
        print("f0 all zero!")
    else:
        out = np.interp(time_frame, 0.005 * nz, f0[nz], left=f0[nz[0]],
                        right=f0[nz[-1]]).astype(np.float32)
    return out, f0_to_coarse_np(out, hp["f0_bin"], hp["f0_min"], hp["f0_max"])
