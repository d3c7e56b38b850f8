"""HuBERT-soft content encoder.

Counterpart of ``diffsvc_tpu/models/hubert.py`` (reference
``network/hubert/hubert_model.py:16-247``): 7-conv feature extractor (320x
downsample), layer-norm + 512->768 projection, grouped conv positional
embedding (k=128, 16 groups), 12-layer post-LN transformer (768 d, 12 heads,
3072 FFN, exact gelu) and the 768->256 soft-unit projection.  Parameter
names follow ``hubert_soft.pt``; the positional conv's weight norm is folded
at load.  Attention is written out (matmul + softmax).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .nn import true_f32_convs

CONV_SPECS = [(10, 5), (3, 2), (3, 2), (3, 2), (3, 2), (2, 2), (2, 2)]


class HubertConfig(NamedTuple):
    dim: int = 768
    num_heads: int = 12
    num_layers: int = 12
    ffn_dim: int = 3072
    proj_dim: int = 256


class FeatureExtractor(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv1d(1, 512, 10, 5, bias=False)
        self.norm0 = nn.GroupNorm(512, 512)
        for i in range(1, 7):
            k, s = CONV_SPECS[i]
            setattr(self, f"conv{i}", nn.Conv1d(512, 512, k, s, bias=False))

    def forward(self, x):
        """x [B, L] 16 kHz -> [B, 512, T] at 50 Hz."""
        x = F.gelu(self.norm0(self.conv0(x[:, None, :])))
        for i in range(1, 7):
            x = F.gelu(getattr(self, f"conv{i}")(x))
        return x


class FeatureProjection(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(512)
        self.projection = nn.Linear(512, dim)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 128, padding=64, groups=16)

    def forward(self, x):
        """x [B, T, D] -> [B, T, D]; drops the conv's extra last frame."""
        y = self.conv(x.transpose(1, 2))[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


class SelfAttention(nn.Module):
    """torch MultiheadAttention's parameters (packed in-projection), math
    written out."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        self.reset_parameters()

    def reset_parameters(self):
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.in_proj_bias)

    def forward(self, x):
        b, t, c = x.shape
        hd = c // self.num_heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1)
        q, k, v = (a.reshape(b, t, self.num_heads, hd).transpose(1, 2)
                   for a in (q, k, v))
        w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        return self.out_proj((w @ v).transpose(1, 2).reshape(b, t, c))


class EncoderLayer(nn.Module):
    """torch TransformerEncoderLayer, post-LN, exact gelu."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.self_attn = SelfAttention(cfg.dim, cfg.num_heads)
        self.linear1 = nn.Linear(cfg.dim, cfg.ffn_dim)
        self.linear2 = nn.Linear(cfg.ffn_dim, cfg.dim)
        self.norm1 = nn.LayerNorm(cfg.dim)
        self.norm2 = nn.LayerNorm(cfg.dim)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.gelu(self.linear1(x))))


class Encoder(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.layers = nn.ModuleList([EncoderLayer(cfg)
                                     for _ in range(cfg.num_layers)])


class HubertSoft(nn.Module):
    def __init__(self, cfg: HubertConfig = HubertConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractor()
        self.feature_projection = FeatureProjection(cfg.dim)
        self.positional_embedding = PositionalConvEmbedding(cfg.dim)
        self.norm = nn.LayerNorm(cfg.dim)
        self.encoder = Encoder(cfg)
        self.proj = nn.Linear(cfg.dim, cfg.proj_dim)

    def encode(self, wav16k: torch.Tensor) -> torch.Tensor:
        """[B, L] 16 kHz -> [B, T, dim] encoder features (the convolutions
        in true f32 whatever the caller's cuDNN TF32 flag)."""
        with true_f32_convs():
            x = self.feature_extractor(wav16k).transpose(1, 2)
            x = self.feature_projection.projection(
                self.feature_projection.norm(x))
            x = self.norm(x + self.positional_embedding(x))
        for layer in self.encoder.layers:
            x = layer(x)
        return x

    @torch.no_grad()
    def units(self, wav16k: torch.Tensor) -> torch.Tensor:
        """Soft units: [B, L] 16 kHz -> [B, T, proj_dim]; the waveform is
        padded by (400-320)/2 on both sides like the reference."""
        pad = (400 - 320) // 2
        return self.proj(self.encode(F.pad(wav16k, (pad, pad))))
