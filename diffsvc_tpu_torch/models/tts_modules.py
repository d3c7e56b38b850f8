"""The FastSpeech transformer stack: FFT blocks of pre-LN self-attention and
a conv FFN.

Counterpart of ``diffsvc_tpu/models/tts_modules.py:27-153`` (reference
``modules/commons/common_layers.py`` EncSALayer and
``modules/fastspeech/tts_modules.py`` FFTBlocks), used by the FS2-full
conditioner (``no_fs2: false``) and the FFT denoiser
(``diff_decoder_type: fft``).  The state-dict names are the reference's
(``layers.{i}.op.layer_norm1``, ``.self_attn.in_proj_weight`` with q/k/v
stacked, ``.self_attn.out_proj``, ``.layer_norm2``, ``.ffn.ffn_1`` (a conv)
and ``.ffn.ffn_2`` (a linear), ``layer_norm``), the names
``diffsvc_tpu/utils/convert_torch.py:156-186`` reads.

Where a direct PyTorch translation would give other numbers than the JAX
package, this one follows JAX:

- GELU is the tanh approximation (``jax.nn.gelu``'s default), not erf;
- masked logits are a finite ``-1e9``: a ``-inf`` mask turns every query of
  an all-padding row into NaN, which the later ``* nonpadding`` keeps;
- the FFN conv keeps the first T outputs and scales them by
  ``kernel_size ** -0.5`` before the activation.  It runs as one matmul
  over the k shifted copies of the input (exact f32 on the card, where a
  cuDNN convolution would take TF32 by PyTorch's default).

Dropout (inverted, at ``dropout`` after the attention and after the FFN,
and 0.1 inside the FFN) runs only when a ``torch.Generator`` is given; it
cannot draw JAX's bits.  The predictors and ``length_regulator`` are not
here: no path of either package calls them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import nn as fnn

RELU_DROPOUT = 0.1     # the reference's TransformerFFNLayer dropout
MASKED = -1e9          # JAX's masked logit


def positional_encoding_for(x: torch.Tensor, offset: int = 1
                            ) -> torch.Tensor:
    """fairseq's sinusoidal positions for [B, T, C] as [1, T, C] f32 (not
    padding-aware: callers mask, as the reference does)."""
    return fnn.sinusoidal_positional_embedding(
        x.shape[1], x.shape[2], offset, device=x.device)[None]


def param(p: torch.Tensor, like: torch.Tensor,
          wdt: Optional[torch.dtype] = None) -> torch.Tensor:
    """A weight in ``like``'s dtype, rounded through ``wdt`` first (the JAX
    package casts every f32 parameter to the compute dtype; the activations
    then follow its type promotion)."""
    if wdt is not None:
        p = p.to(wdt)
    return p.to(like.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: kept entries scaled by 1 / (1 - rate); identity at
    rate 0 or without a generator."""
    if rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, wdt=None) -> torch.Tensor:
    return F.layer_norm(x, ln.normalized_shape, param(ln.weight, x, wdt),
                        param(ln.bias, x, wdt), ln.eps)


def linear(lin: nn.Linear, x: torch.Tensor, wdt=None) -> torch.Tensor:
    b = None if lin.bias is None else param(lin.bias, x, wdt)
    return F.linear(x, param(lin.weight, x, wdt), b)


class MultiheadAttention(nn.Module):
    """fairseq self-attention without biases: ``in_proj_weight`` [3C, C]
    (q, k, v stacked) and ``out_proj``."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.out_proj = nn.Linear(dim, dim, bias=False)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """fairseq's init: xavier-uniform, the stacked in-projection at gain
        1/sqrt(2)."""
        nn.init.xavier_uniform_(self.in_proj_weight, gain=1 / math.sqrt(2))
        nn.init.xavier_uniform_(self.out_proj.weight)

    def forward(self, x, key_padding_mask=None, wdt=None):
        b, t, c = x.shape
        hd = c // self.num_heads
        q, k, v = (y.reshape(b, t, self.num_heads, hd) for y in F.linear(
            x, param(self.in_proj_weight, x, wdt)).chunk(3, dim=-1))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        if key_padding_mask is not None:
            logits = torch.where(key_padding_mask[:, None, None, :],
                                 torch.full((), MASKED, dtype=logits.dtype,
                                            device=x.device), logits)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, c)
        return linear(self.out_proj, out, wdt)


class TransformerFFNLayer(nn.Module):
    """``ffn_1`` Conv1d(C, 4C, k, padding k // 2) -> first T outputs ->
    ``* k ** -0.5`` -> tanh GELU -> dropout -> ``ffn_2`` Linear(4C, C)."""

    def __init__(self, dim: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.ffn_1 = nn.Conv1d(dim, 4 * dim, kernel_size,
                               padding=kernel_size // 2)
        self.ffn_2 = nn.Linear(4 * dim, dim)

    def forward(self, x, relu_dropout: float = 0.0, generator=None, wdt=None):
        k = self.kernel_size
        t = x.shape[1]
        w = param(self.ffn_1.weight, x, wdt)                  # [4C, C, k]
        taps = F.pad(x, (0, 0, k // 2, k // 2)).unfold(1, k, 1)  # [B,T',C,k]
        y = F.linear(taps[:, :t].reshape(x.shape[0], t, -1),
                     w.reshape(w.shape[0], -1),
                     param(self.ffn_1.bias, x, wdt))
        y = F.gelu(y * k ** -0.5, approximate="tanh")
        y = dropout(y, relu_dropout, generator)
        return linear(self.ffn_2, y, wdt)


class EncSALayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, kernel_size: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim)
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.layer_norm2 = nn.LayerNorm(dim)
        self.ffn = TransformerFFNLayer(dim, kernel_size)

    def forward(self, x, padding_mask, rate: float = 0.0, generator=None,
                wdt=None):
        """Pre-LN block (``tts_modules.apply_enc_layer``): dropout at
        ``rate`` after the attention and after the FFN, the FFN's own 0.1
        inside, all only with a ``generator``."""
        nonpadding = 1.0 - padding_mask.to(x.dtype)[:, :, None]
        y = self.self_attn(layer_norm(self.layer_norm1, x, wdt),
                           key_padding_mask=padding_mask, wdt=wdt)
        x = (x + dropout(y, rate, generator)) * nonpadding
        y = self.ffn(layer_norm(self.layer_norm2, x, wdt),
                     relu_dropout=RELU_DROPOUT if rate > 0.0 else 0.0,
                     generator=generator, wdt=wdt)
        return (x + dropout(y, rate, generator)) * nonpadding


class TransformerEncoderLayer(nn.Module):
    """The reference's wrapper: the block lives under ``op``."""

    def __init__(self, dim: int, num_heads: int, kernel_size: int):
        super().__init__()
        self.op = EncSALayer(dim, num_heads, kernel_size)

    def forward(self, *args, **kwargs):
        return self.op(*args, **kwargs)


class FFTBlocks(nn.Module):
    """``num_layers`` encoder layers and a last LayerNorm, everything
    multiplied by the nonpadding mask (``apply_fft_blocks``)."""

    def __init__(self, dim: int, num_layers: int, kernel_size: int,
                 num_heads: int):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(dim, num_heads, kernel_size)
            for _ in range(num_layers))
        self.layer_norm = nn.LayerNorm(dim)

    def forward(self, x, padding_mask, rate: float = 0.0, generator=None,
                wdt=None):
        nonpadding = 1.0 - padding_mask.to(x.dtype)[:, :, None]
        x = x * nonpadding
        for layer in self.layers:
            x = layer(x, padding_mask, rate, generator, wdt)
        return layer_norm(self.layer_norm, x, wdt) * nonpadding
