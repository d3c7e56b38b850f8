"""Functional NN primitives of the DiffNet step embedding and pe.

Counterpart of the ``linear`` / ``mish`` / ``sinusoidal_pos_emb`` /
``group_norm`` / ``sinusoidal_positional_embedding`` part of
``diffsvc_tpu/models/nn.py``, plus the reference's channel LayerNorm
(``common_layers.LayerNorm(dim=1)``); the port's convolutions are torch
``nn.Conv1d`` / ``nn.ConvTranspose1d`` modules holding the reference's
weights.  ``linear`` takes torch's Linear layout [out, in].
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def true_f32_convs():
    """cuDNN's f32 convolutions in true f32 inside the block, whatever the
    caller's ``torch.backends.cudnn.allow_tf32``: PyTorch's default (True)
    runs them as single-pass TF32 (about three decimal digits), where the
    JAX package's f32 path is true f32.  The caller's flag is restored
    after the block; no other cuDNN flag is touched."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None):
    """y = x @ w.T + b (torch Linear weight [out, in])."""
    return F.linear(x, w, b)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """DiffNet's diffusion-step embedding (reference net.py:32-44), f32."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, device=t.device,
                                   dtype=torch.float32) * -emb)
    args = t[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def group_norm(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    """``gn`` (a GroupNorm module's groups, eps and affine weights) on
    channels-last [B, T, C]: statistics over T and each group's
    channels."""
    return F.group_norm(x.transpose(1, 2), gn.num_groups, gn.weight, gn.bias,
                        gn.eps).transpose(1, 2)


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over the channels of channels-first [B, C, T] (reference
    ``common_layers.LayerNorm(dim=1)``)."""

    def forward(self, x):
        return super().forward(x.transpose(1, -1)).transpose(1, -1)


@functools.lru_cache(maxsize=32)
def _positions(length: int, dim: int, offset: int) -> np.ndarray:
    half = dim // 2
    emb = np.exp(np.arange(half, dtype=np.float64)
                 * -(math.log(10000.0) / (half - 1)))
    pos = np.arange(offset, length + offset, dtype=np.float64)[:, None] * emb
    out = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if dim % 2 == 1:
        out = np.concatenate([out, np.zeros((length, 1))], axis=1)
    return out.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _positions_on(length: int, dim: int, offset: int, device) -> torch.Tensor:
    return torch.from_numpy(_positions(length, dim, offset)).to(device)


def sinusoidal_positional_embedding(length: int, dim: int, offset: int = 1,
                                    device=None) -> torch.Tensor:
    """fairseq's sinusoidal table [length, dim] (``common_layers.py:
    88-147``): [sin | cos] halves, not interleaved, positions from
    ``offset`` (1: the padding index shift), computed in float64.  The
    table is uploaded to ``device`` once and kept (read-only): a CUDA graph
    cannot capture an upload from pageable host memory."""
    return _positions_on(length, dim, offset,
                         None if device is None else torch.device(device))
