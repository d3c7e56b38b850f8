"""Functional NN primitives the DiffNet step embedding uses.

Counterpart of the ``linear`` / ``mish`` / ``sinusoidal_pos_emb`` part of
``diffsvc_tpu/models/nn.py``; the port's convolutions are torch
``nn.Conv1d`` / ``nn.ConvTranspose1d`` modules holding the reference's
weights.  ``linear`` takes torch's Linear layout [out, in].
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


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
