"""Device polyphase resampler (44.1 kHz -> 16 kHz for HuBERT).

Counterpart of ``diffsvc_tpu/ops/resample.py``: scipy.signal.resample_poly's
default design (kaiser(5.0)-windowed FIR low-pass with 10*max(up, down)
half-length, zero-phase alignment, ceil-length output), designed on the
host in numpy (cached) and applied on the wav's device as overlapping
``[n_blocks, Lw]`` windows times one ``[Lw, up]`` tap matrix (f32, in
true f32 under PyTorch's default ``allow_tf32 = False`` for matmuls).

Only the fused serving program (``infer/fused.py``) uses it; the modular
path resamples on the host (``utils/audio_io.resample``), as the JAX
package's does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=16)
def _design(orig_sr: int, target_sr: int):
    """(subfilters [up, T], up, down, half_len), scipy-compatible."""
    from scipy.signal import firwin

    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate,
               window=("kaiser", 5.0)) * up
    t_taps = -(-len(h) // up)
    sub = np.zeros((up, t_taps), np.float32)
    for p in range(up):
        taps = h[p::up]
        sub[p, : len(taps)] = taps
    return sub, up, down, half_len


def resample_length(n_in: int, orig_sr: int, target_sr: int) -> int:
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    return -(-n_in * up // down)


@functools.lru_cache(maxsize=16)
def _block_design(orig_sr: int, target_sr: int):
    """One block of `down` input samples yields `up` outputs: (G [Lw, up],
    offset, Lw, up, down) with y[b, r] = sum_j x[b*down + offset + j] G[j, r].
    """
    sub, up, down, half_len = _design(orig_sr, target_sr)
    t_taps = sub.shape[1]
    i = np.arange(up, dtype=np.int64) * down + half_len
    phase = (i % up).astype(np.int64)
    c = (i // up).astype(np.int64)
    c_min, c_max = int(c.min()), int(c.max())
    offset = c_min - (t_taps - 1)
    l_w = c_max - c_min + t_taps
    g = np.zeros((l_w, up), np.float32)
    for r in range(up):
        for t in range(t_taps):
            g[(c[r] - c_min + t_taps - 1) - t, r] = sub[phase[r], t]
    return g, offset, l_w, up, down


@functools.lru_cache(maxsize=16)
def _taps(orig_sr: int, target_sr: int, device: torch.device) -> torch.Tensor:
    """The tap matrix G on ``device``, uploaded once (a CUDA graph cannot
    capture the upload)."""
    return torch.from_numpy(_block_design(orig_sr, target_sr)[0]).to(device)


def resample_poly_device(x: torch.Tensor, orig_sr: int, target_sr: int
                         ) -> torch.Tensor:
    """x [..., n] float -> [..., ceil(n*up/down)] float32 on x's device,
    scipy.signal.resample_poly(x, up, down) to float32 accuracy.

    The polyphase identity y[m] = sum_t h[p_m + t*up] x[i_m//up - t]
    (i_m = m*down + half_len), blocked per `down` input samples: windows
    b..b+q of the padded signal's [*, down] blocks, concatenated, times G.
    """
    x = x.float()
    if orig_sr == target_sr:
        return x
    n_in = int(x.shape[-1])
    n_out = resample_length(n_in, orig_sr, target_sr)
    _, offset, l_w, up, down = _block_design(int(orig_sr), int(target_sr))
    n_blocks = -(-n_out // up)
    q, rem = divmod(l_w, down)
    pad_left = max(0, -offset)
    start = offset + pad_left
    total = start + (n_blocks + q + 1) * down
    xp = F.pad(x, (pad_left, max(0, total - n_in - pad_left)))
    blocks = xp[..., start: start + (n_blocks + q + 1) * down]
    blocks = blocks.reshape(*x.shape[:-1], -1, down)
    parts = [blocks[..., k: k + n_blocks, :] for k in range(q)]
    if rem:
        parts.append(blocks[..., q: q + n_blocks, :rem])
    windows = torch.cat(parts, dim=-1)                  # [..., n_blocks, Lw]
    g = _taps(int(orig_sr), int(target_sr), x.device)
    y = windows @ g
    return y.reshape(*x.shape[:-1], -1)[..., :n_out]

