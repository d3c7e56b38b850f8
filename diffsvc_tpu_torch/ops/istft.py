"""Windowed inverse STFT with normalized overlap-add.

Counterpart of ``diffsvc_tpu/ops/istft.py:43-74``, the synthesis of the
iSTFT-head vocoder (``vocoders/istft_head.py``): each frame's spectrum goes
through the inverse real DFT (``torch.fft.irfft``; it ignores the imaginary
parts of the DC and Nyquist bins, as JAX's cos/sin synthesis matrices do),
is windowed, and the frames are summed hop block by hop block; the sum is
divided by the summed squared window floored at 1e-8, and the first
``n_fft // 2`` samples are trimmed (the frames are centred).

``torch.istft`` is not used: its NOLA check raises on envelopes that this
floors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .mel import hann_window, hann_window_on


@functools.lru_cache(maxsize=32)
def _envelope_on(n_fft: int, hop: int, t: int, device: torch.device
                 ) -> torch.Tensor:
    """max(sum of squared windows, 1e-8) over the [t + q - 1, hop]
    blocks of the overlap-add, uploaded once per device (a CUDA graph
    cannot capture the upload)."""
    q = n_fft // hop
    win = hann_window(n_fft)
    w2 = (win * win).reshape(q, hop)
    env = np.zeros((t + q - 1, hop), np.float32)
    for j in range(q):
        env[j: j + t] += w2[j]
    return torch.from_numpy(np.maximum(env, 1e-8)).to(device)


def istft(re: torch.Tensor, im: torch.Tensor, *, n_fft: int, hop: int,
          length: int) -> torch.Tensor:
    """re/im [..., T, n_fft//2 + 1] (one frame per hop) -> [..., length].

    Sample 0 is frame 0's window centre (librosa's ``center=True``).
    Requires ``hop | n_fft`` (every shipped profile: 2048/512, 512/128)."""
    assert n_fft % hop == 0, (n_fft, hop)
    q = n_fft // hop
    t = re.shape[-2]
    win = hann_window_on(n_fft, re.device)
    frames = torch.fft.irfft(torch.complex(re, im), n=n_fft, dim=-1) * win
    fb = frames.reshape(*frames.shape[:-1], q, hop)
    # frame f's j-th hop block lands at block f + j
    y = sum(F.pad(fb[..., j, :], (0, 0, j, q - 1 - j)) for j in range(q))
    y = (y / _envelope_on(n_fft, hop, t, re.device)).flatten(-2)
    start = n_fft // 2
    return F.pad(y, (0, n_fft))[..., start: start + length]
