"""MelGAN: the generator (with causal mode), the discriminator and the
multi-scale discriminator.

Counterpart of ``diffsvc_tpu/vocoders/melgan.py:19-217`` (reference
``modules/parallel_wavegan/models/melgan.py``).  The generator: a k=7 conv
in, per scale [leaky, ConvTranspose(2r, r), ``stacks`` residual stacks of
dilation 3^j, each stack(x) + a learned 1x1 skip conv of x (not an
identity)], leaky, a k=7 conv out and tanh; reflection padding before
every conv that is not strided.  In causal mode the reflection padding is
on the left alone and each transposed conv drops its last ``r`` samples
(``layers/causal_conv.py:12-56``).  Its parameters are named as the JAX
package's tree (``conv_in``, ``ups.{i}``, ``blocks.{i}.{j}.c1/c2/skip``,
``conv_out``).

The discriminators keep the official layout (``layers.{i}``: the first a
[ReflectionPad, conv, leaky] Sequential, then [conv, leaky] ones, the last
a bare conv; the multi-scale one's ``discriminators.{i}.``), so the JAX
package's ``convert_discriminator`` and ``convert_multiscale_
discriminator`` take their ``state_dict()``.  Between scales the input is
average-pooled (4, 2, padding 1) without counting the padding.  Every
cuDNN convolution here runs in true f32 (``models.nn.true_f32_convs``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.nn import true_f32_convs


class MelGANConfig(NamedTuple):
    in_channels: int = 80
    out_channels: int = 1
    channels: int = 512
    upsample_scales: Tuple[int, ...] = (8, 8, 2, 2)
    stack_kernel_size: int = 3
    stacks: int = 3
    use_causal_conv: bool = False


class ResidualStack(nn.Module):
    def __init__(self, ch: int, k: int):
        super().__init__()
        self.c1 = nn.Conv1d(ch, ch, k)
        self.c2 = nn.Conv1d(ch, ch, 1)
        self.skip = nn.Conv1d(ch, ch, 1)


class MelGANGenerator(nn.Module):
    def __init__(self, cfg: MelGANConfig = MelGANConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        ch = cfg.channels
        self.conv_in = nn.Conv1d(cfg.in_channels, ch, 7)
        self.ups = nn.ModuleList()
        self.blocks = nn.ModuleList()
        for r in cfg.upsample_scales:
            self.ups.append(nn.ConvTranspose1d(
                ch, ch // 2, 2 * r, r,
                padding=0 if cfg.use_causal_conv else r // 2))
            ch //= 2
            self.blocks.append(nn.ModuleList(
                ResidualStack(ch, cfg.stack_kernel_size)
                for _ in range(cfg.stacks)))
        self.conv_out = nn.Conv1d(ch, cfg.out_channels, 7)
        self.to(device)

    def _pad(self, x, pad: int):
        """The reflection padding before a conv of receptive field
        ``pad + 1``: ``pad // 2`` on each side, or ``pad`` on the left in
        causal mode."""
        if self.cfg.use_causal_conv:
            return F.pad(x, (pad, 0), mode="reflect")
        return F.pad(x, (pad // 2, pad // 2), mode="reflect")

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, M] -> wav [B, T * prod(scales)]."""
        cfg = self.cfg
        k = cfg.stack_kernel_size
        with true_f32_convs():
            x = self.conv_in(self._pad(mel.transpose(1, 2), 6))
            for r, up, stacks in zip(cfg.upsample_scales, self.ups,
                                     self.blocks):
                x = up(F.leaky_relu(x, 0.2))
                if cfg.use_causal_conv:
                    x = x[:, :, :-r]
                for j, blk in enumerate(stacks):
                    d = k ** j
                    y = self._pad(F.leaky_relu(x, 0.2), (k - 1) * d)
                    y = F.conv1d(y, blk.c1.weight, blk.c1.bias, dilation=d)
                    y = blk.c2(F.leaky_relu(y, 0.2))
                    x = blk.skip(x) + y
            x = self.conv_out(self._pad(F.leaky_relu(x, 0.2), 6))
        return torch.tanh(x)[:, 0, :]


# ---------------------------------------------------------------------------
# Discriminators (melgan.py: MelGANDiscriminator :194-315,
# MelGANMultiScaleDiscriminator :317-413)
# ---------------------------------------------------------------------------

class MelGANDiscriminatorConfig(NamedTuple):
    in_channels: int = 1
    out_channels: int = 1
    kernel_sizes: Tuple[int, int] = (5, 3)
    channels: int = 16
    max_downsample_channels: int = 1024
    downsample_scales: Tuple[int, ...] = (4, 4, 4, 4)
    scales: int = 3          # multi-scale only
    pool_kernel: int = 4     # AvgPool1d(kernel 4, stride 2, pad 1,
    pool_stride: int = 2     #           count_include_pad=False)
    pool_pad: int = 1


def _disc_channel_plan(cfg: MelGANDiscriminatorConfig):
    """(in, out, kernel, stride, groups) per layer."""
    plan = [(cfg.in_channels, cfg.channels,
             cfg.kernel_sizes[0] * cfg.kernel_sizes[1], 1, 1)]
    in_chs = cfg.channels
    for s in cfg.downsample_scales:
        out_chs = min(in_chs * s, cfg.max_downsample_channels)
        plan.append((in_chs, out_chs, s * 10 + 1, s, in_chs // 4))
        in_chs = out_chs
    out_chs = min(in_chs * 2, cfg.max_downsample_channels)
    plan.append((in_chs, out_chs, cfg.kernel_sizes[0], 1, 1))
    plan.append((out_chs, cfg.out_channels, cfg.kernel_sizes[1], 1, 1))
    return plan


class MelGANDiscriminator(nn.Module):
    def __init__(self, cfg: MelGANDiscriminatorConfig =
                 MelGANDiscriminatorConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        plan = _disc_channel_plan(cfg)
        (c_in, c_out, k, _, _), last = plan[0], len(plan) - 1
        self.layers = nn.ModuleList([nn.Sequential(
            nn.ReflectionPad1d((k - 1) // 2), nn.Conv1d(c_in, c_out, k),
            nn.LeakyReLU(0.2))])
        for i, (c_in, c_out, k, s, g) in enumerate(plan[1:], 1):
            conv = nn.Conv1d(c_in, c_out, k, s, padding=(k - 1) // 2,
                             groups=g)
            self.layers.append(conv if i == last else nn.Sequential(
                conv, nn.LeakyReLU(0.2)))
        self.to(device)

    def forward(self, wav: torch.Tensor) -> list:
        """wav [B, T] (or [B, C, T]) -> every layer's output [B, C', T'],
        the score map last (for feature matching)."""
        x = wav[:, None, :] if wav.dim() == 2 else wav
        outs = []
        with true_f32_convs():
            for f in self.layers:
                x = f(x)
                outs.append(x)
        return outs


class MelGANMultiScaleDiscriminator(nn.Module):
    def __init__(self, cfg: MelGANDiscriminatorConfig =
                 MelGANDiscriminatorConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.discriminators = nn.ModuleList(MelGANDiscriminator(cfg)
                                            for _ in range(cfg.scales))
        self.to(device)

    def forward(self, wav: torch.Tensor) -> list:
        """wav [B, T] -> per scale the list of layer outputs."""
        cfg = self.cfg
        x = wav[:, None, :]
        outs = []
        for d in self.discriminators:
            outs.append(d(x))
            x = F.avg_pool1d(x, cfg.pool_kernel, cfg.pool_stride,
                             cfg.pool_pad, count_include_pad=False)
        return outs
