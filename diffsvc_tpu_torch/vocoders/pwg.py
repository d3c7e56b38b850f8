"""ParallelWaveGAN: the generator, both discriminators and the checkpoint
wrapper, in the official module layout.

Counterpart of ``diffsvc_tpu/vocoders/pwg.py:31-185`` and ``:323-403``
(reference ``modules/parallel_wavegan/models/parallel_wavegan.py``).  The
modules keep the official state-dict keys (``first_conv``,
``upsample_net.conv_in``, ``upsample_net.upsample.up_layers.{i}``,
``conv_layers.{j}.conv/conv1x1_aux/conv1x1_out/conv1x1_skip``,
``last_conv_layers.{1,3}``; the discriminator's flat
``conv_layers.{2i}``; the residual discriminator's ``first_conv.0``), so an
official ``checkpoint-*steps.pkl`` or a reference-trainer ``.ckpt`` loads
through ``utils/convert.fold_weight_norm`` and the JAX package's
``pwg.convert``, ``convert_discriminator`` and
``convert_residual_discriminator`` take the modules' ``state_dict()``.

The generator: a 1x1 conv on the noise, the aux mel upsampled by a context
conv and per scale [nearest stretch, (1, 2s+1) smoothing conv], ``layers``
gated residual blocks (dilation 2^(i mod layers/stacks), residual scaled by
sqrt(0.5)), then relu -> 1x1 -> relu -> 1x1 on the skip sum.  Its
cuDNN convolutions run in true f32 (``models.nn.true_f32_convs``).
"""

from __future__ import annotations

import glob
import math
import os
import re
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from ..models.nn import true_f32_convs


class PWGConfig(NamedTuple):
    in_channels: int = 1
    out_channels: int = 1
    kernel_size: int = 3
    layers: int = 30
    stacks: int = 3
    residual_channels: int = 64
    gate_channels: int = 128
    skip_channels: int = 64
    aux_channels: int = 80
    aux_context_window: int = 2
    upsample_scales: Tuple[int, ...] = (4, 4, 4, 4)
    use_pitch_embed: bool = False

    @classmethod
    def from_dict(cls, g: dict):
        ups = g.get("upsample_params", {}).get(
            "upsample_scales", g.get("upsample_scales", (4, 4, 4, 4)))
        return cls(
            in_channels=g.get("in_channels", 1),
            out_channels=g.get("out_channels", 1),
            kernel_size=g.get("kernel_size", 3),
            layers=g.get("layers", 30),
            stacks=g.get("stacks", 3),
            residual_channels=g.get("residual_channels", 64),
            gate_channels=g.get("gate_channels", 128),
            skip_channels=g.get("skip_channels", 64),
            aux_channels=g.get("aux_channels", 80),
            aux_context_window=g.get("aux_context_window", 2),
            upsample_scales=tuple(ups),
            use_pitch_embed=bool(g.get("use_pitch_embed", False)))


class Stretch2d(nn.Module):
    """Nearest-neighbour stretch of the time (last) axis."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return torch.repeat_interleave(x, self.scale, dim=-1)


class UpsampleNetwork(nn.Module):
    def __init__(self, scales):
        super().__init__()
        self.up_layers = nn.ModuleList()
        for s in scales:
            conv = nn.Conv2d(1, 1, (1, 2 * s + 1), padding=(0, s), bias=False)
            nn.init.constant_(conv.weight, 1.0 / (2 * s + 1))
            self.up_layers.extend([Stretch2d(s), conv])

    def forward(self, c):
        """[B, M, T] -> [B, M, T * prod(scales)]."""
        c = c.unsqueeze(1)
        for f in self.up_layers:
            c = f(c)
        return c.squeeze(1)


class ConvInUpsampleNetwork(nn.Module):
    def __init__(self, scales, aux_channels: int, aux_context_window: int):
        super().__init__()
        self.conv_in = nn.Conv1d(aux_channels, aux_channels,
                                 2 * aux_context_window + 1, bias=False)
        self.upsample = UpsampleNetwork(scales)

    def forward(self, c):
        """The context conv (valid: it consumes the context window), then
        the upsampling."""
        return self.upsample(self.conv_in(c))


class ResidualBlock(nn.Module):
    def __init__(self, k: int, rc: int, gc: int, sc: int, aux: int,
                 dilation: int):
        super().__init__()
        self.conv = nn.Conv1d(rc, gc, k, padding=(k - 1) // 2 * dilation,
                              dilation=dilation)
        if aux > 0:
            self.conv1x1_aux = nn.Conv1d(aux, gc, 1, bias=False)
        self.conv1x1_out = nn.Conv1d(gc // 2, rc, 1)
        self.conv1x1_skip = nn.Conv1d(gc // 2, sc, 1)

    def forward(self, x, c=None):
        """(the residual output, the skip) of [B, C, T]."""
        y = self.conv(x)
        if c is not None:
            y = y + self.conv1x1_aux(c)
        xa, xb = y.chunk(2, dim=1)
        y = torch.tanh(xa) * torch.sigmoid(xb)
        return ((x + self.conv1x1_out(y)) * math.sqrt(0.5),
                self.conv1x1_skip(y))


def _dilation(i: int, layers: int, stacks: int) -> int:
    return 2 ** (i % (layers // stacks))


class ParallelWaveGANGenerator(nn.Module):
    def __init__(self, cfg: PWGConfig, device=None):
        super().__init__()
        self.cfg = cfg
        rc, gc, sc = (cfg.residual_channels, cfg.gate_channels,
                      cfg.skip_channels)
        self.first_conv = nn.Conv1d(cfg.in_channels, rc, 1)
        self.upsample_net = ConvInUpsampleNetwork(
            cfg.upsample_scales, cfg.aux_channels, cfg.aux_context_window)
        self.conv_layers = nn.ModuleList(
            ResidualBlock(cfg.kernel_size, rc, gc, sc, cfg.aux_channels,
                          _dilation(i, cfg.layers, cfg.stacks))
            for i in range(cfg.layers))
        self.last_conv_layers = nn.ModuleList([
            nn.ReLU(), nn.Conv1d(sc, sc, 1), nn.ReLU(),
            nn.Conv1d(sc, cfg.out_channels, 1)])
        if cfg.use_pitch_embed:
            # reference parallel_wavegan.py:151-153: c = c_proj([c; embed(p)])
            self.pitch_embed = nn.Embedding(300, cfg.aux_channels, 0)
            self.c_proj = nn.Linear(2 * cfg.aux_channels, cfg.aux_channels)
        self.to(device)

    def forward(self, z: torch.Tensor, mel: torch.Tensor, pitch=None):
        """z [B, L] noise at the sample rate, mel [B, T, M] (scaler-
        normalized, edge-padded by the context window), pitch [B, T] coarse
        f0 bins when the model embeds it.  Returns wav [B, L]; L is at most
        (T - 2 * aux_context_window) * prod(scales)."""
        with true_f32_convs():
            if self.cfg.use_pitch_embed and pitch is not None:
                mel = self.c_proj(torch.cat([mel, self.pitch_embed(pitch)],
                                            -1))
            c = self.upsample_net(mel.transpose(1, 2))[:, :, : z.shape[1]]
            x = self.first_conv(z[:, None, :])
            skips = 0.0
            for blk in self.conv_layers:
                x, skip = blk(x, c)
                skips = skips + skip
            s = skips * math.sqrt(1.0 / len(self.conv_layers))
            for f in self.last_conv_layers:
                s = f(s)
        return s[:, 0, :]


# ---------------------------------------------------------------------------
# Discriminators (parallel_wavegan.py: ParallelWaveGANDiscriminator :207-303,
# ResidualParallelWaveGANDiscriminator :305-435)
# ---------------------------------------------------------------------------

class PWGDiscriminatorConfig(NamedTuple):
    in_channels: int = 1
    out_channels: int = 1
    kernel_size: int = 3
    layers: int = 10
    conv_channels: int = 64
    dilation_factor: int = 1


class ResidualPWGDiscriminatorConfig(NamedTuple):
    in_channels: int = 1
    out_channels: int = 1
    kernel_size: int = 3
    layers: int = 30
    stacks: int = 3
    residual_channels: int = 64
    gate_channels: int = 128
    skip_channels: int = 64


def _disc_layer_plan(cfg: PWGDiscriminatorConfig):
    """(c_in, c_out, dilation) per conv: layer 0 dilation 1 from
    in_channels, layer i > 0 dilation i (or dilation_factor^i); the last
    conv dilation 1 to out_channels (parallel_wavegan.py:243-262)."""
    plan = []
    for i in range(cfg.layers - 1):
        if i == 0:
            dilation, c_in = 1, cfg.in_channels
        else:
            dilation = i if cfg.dilation_factor == 1 \
                else cfg.dilation_factor ** i
            c_in = cfg.conv_channels
        plan.append((c_in, cfg.conv_channels, dilation))
    plan.append((cfg.conv_channels, cfg.out_channels, 1))
    return plan


class ParallelWaveGANDiscriminator(nn.Module):
    """A flat ``conv_layers`` list alternating [conv, LeakyReLU(0.2)], the
    last conv alone; every conv keeps the length."""

    def __init__(self, cfg: PWGDiscriminatorConfig = PWGDiscriminatorConfig(),
                 device=None):
        super().__init__()
        self.cfg = cfg
        k = cfg.kernel_size
        layers = []
        for c_in, c_out, d in _disc_layer_plan(cfg):
            layers += [nn.Conv1d(c_in, c_out, k, padding=(k - 1) // 2 * d,
                                 dilation=d), nn.LeakyReLU(0.2)]
        self.conv_layers = nn.ModuleList(layers[:-1])
        self.to(device)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """wav [B, T] -> score map [B, out_channels, T]."""
        x = wav[:, None, :]
        for f in self.conv_layers:
            x = f(x)
        return x


class ResidualParallelWaveGANDiscriminator(nn.Module):
    """The generator's residual stack without aux conditioning, a LeakyReLU
    around the 1x1 convs in and out (forward :393-414)."""

    def __init__(self, cfg: ResidualPWGDiscriminatorConfig =
                 ResidualPWGDiscriminatorConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        rc, gc, sc = (cfg.residual_channels, cfg.gate_channels,
                      cfg.skip_channels)
        self.first_conv = nn.Sequential(nn.Conv1d(cfg.in_channels, rc, 1),
                                        nn.LeakyReLU(0.2))
        self.conv_layers = nn.ModuleList(
            ResidualBlock(cfg.kernel_size, rc, gc, sc, -1,
                          _dilation(i, cfg.layers, cfg.stacks))
            for i in range(cfg.layers))
        self.last_conv_layers = nn.ModuleList([
            nn.LeakyReLU(0.2), nn.Conv1d(sc, sc, 1), nn.LeakyReLU(0.2),
            nn.Conv1d(sc, cfg.out_channels, 1)])
        self.to(device)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.first_conv(wav[:, None, :])
        skips = 0.0
        for blk in self.conv_layers:
            x, skip = blk(x)
            skips = skips + skip
        s = skips * math.sqrt(1.0 / len(self.conv_layers))
        for f in self.last_conv_layers:
            s = f(s)
        return s


# ---------------------------------------------------------------------------
# The checkpoint wrapper (reference network/vocoders/pwg.py:54-103)
# ---------------------------------------------------------------------------

class PWGGenerator:
    """A PWG directory: ``config.yaml`` (``generator_params``, ``hop_size``)
    and the latest ``model_ckpt_steps_*.ckpt`` (reference trainer:
    ``state_dict`` with ``model_gen.`` keys) or ``checkpoint-*steps.pkl``
    (official: ``model.generator``, with the StandardScaler's
    ``stats.h5`` (read with h5py, imported here alone) or ``stats.npy``
    [mean; scale])."""

    def __init__(self, hp, device="cpu"):
        import yaml

        from ..utils import convert

        self.hp = hp
        self.device = torch.device(device)
        base_dir = hp.get("vocoder_ckpt") or "wavegan_pretrained"
        with open(f"{base_dir}/config.yaml", encoding="utf-8") as f:
            config = yaml.safe_load(f)
        self.cfg = PWGConfig.from_dict(config.get("generator_params", config))
        self.hop = int(config.get("hop_size", hp.get("hop_size", 128)))
        ckpts = glob.glob(f"{base_dir}/model_ckpt_steps_*.ckpt") or \
            glob.glob(f"{base_dir}/checkpoint-*steps.pkl")
        if not ckpts:
            raise FileNotFoundError(f"no PWG checkpoint under {base_dir}")
        ckpt_path = max(ckpts, key=lambda x: int(re.findall(r"(\d+)", x)[-1]))
        ckpt = convert.torch_load(ckpt_path)
        self.scaler_mean = self.scaler_scale = None
        if "state_dict" in ckpt:
            sd = convert.strip_prefix(ckpt["state_dict"], "model_gen.")
        else:
            sd = ckpt["model"]["generator"]
            if os.path.exists(f"{base_dir}/stats.h5"):
                import h5py

                with h5py.File(f"{base_dir}/stats.h5", "r") as f:
                    self.scaler_mean = np.asarray(f["mean"])
                    self.scaler_scale = np.asarray(f["scale"])
            elif os.path.exists(f"{base_dir}/stats.npy"):
                self.scaler_mean, self.scaler_scale = np.load(
                    f"{base_dir}/stats.npy")
            else:
                print(f"| WARNING: no stats.h5/stats.npy under {base_dir} — "
                      "official PWG generators expect StandardScaler-"
                      "normalized mel; output will be wrong without it")
        self.gen = ParallelWaveGANGenerator(self.cfg)
        convert.load_reference_state(self.gen, convert.fold_weight_norm(sd))
        self.gen.to(self.device).eval()
        print(f"| Loaded PWG from {ckpt_path}")

    @torch.no_grad()
    def spec2wav(self, mel, f0=None, seed: int = 0):
        """log10-mel [T, M] -> wav [T * hop] (numpy f32): scaler-normalized,
        edge-padded by the context window, the noise
        ``np.random.RandomState(seed).randn(1, T * hop)`` (the JAX package's
        draw, so every device sees the same z)."""
        c = np.asarray(mel, np.float32)
        if self.scaler_mean is not None:
            c = (c - self.scaler_mean) / self.scaler_scale
        pad = self.cfg.aux_context_window
        c = np.pad(c, ((pad, pad), (0, 0)), "edge").astype(np.float32)
        z = np.random.RandomState(seed).randn(
            1, mel.shape[0] * self.hop).astype(np.float32)
        pitch = None
        if self.cfg.use_pitch_embed:
            from ..ops.pitch import f0_to_coarse_np

            if f0 is None:
                raise ValueError("PWG with use_pitch_embed needs f0")
            pitch = f0_to_coarse_np(
                np.asarray(f0, np.float32), self.hp.get("f0_bin", 256),
                self.hp.get("f0_min", 80.0), self.hp.get("f0_max", 750.0))
            pitch = torch.as_tensor(np.pad(pitch, (pad, pad), "edge")[None],
                                    device=self.device)
        y = self.gen(torch.as_tensor(z, device=self.device),
                     torch.as_tensor(c[None], device=self.device), pitch)
        return y[0].cpu().numpy()
