"""HiFi-GAN v1 generator (+ NSF harmonic source).

Counterpart of ``diffsvc_tpu/vocoders/generator.py`` (reference
``modules/nsf_hifigan/models.py:148-396`` and
``modules/hifigan/hifigan.py:104-178``).  The module keeps the reference
names (``conv_pre``, ``ups.{i}``, ``resblocks.{i*n+j}.convs1.{d}``,
``noise_convs.{i}``, ``m_source.l_linear``, ``conv_post``); weight norm is
folded when a checkpoint is loaded (``utils/convert.py``).

Two forwards:
- :func:`apply` — the whole generator in plain torch (the reference math);
- :func:`apply_serving` — the serving path: a plain-torch prologue
  (``conv_pre``, the stages before s0, stage s0's ConvT + NSF injection and
  the NSF ``noise_convs``) and K3 (``ops/hopper/vocoder_tail.py``) for the
  rest, the Hopper kernels for CUDA tensors.

Both run cuDNN's convolutions in true f32 (``models.nn.true_f32_convs``),
as the JAX package's f32 path is, whatever the caller's TF32 flag.

The NSF source randomness is passed in explicitly (:func:`draw_randoms`),
so two implementations can be fed the same draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.nn import true_f32_convs
from ..ops.hopper import vocoder_tail

LRELU_SLOPE = 0.1


class HifiGanConfig(NamedTuple):
    num_mels: int = 80
    upsample_initial_channel: int = 512
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    resblock: str = "1"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    sampling_rate: int = 24000
    use_nsf: bool = False
    harmonic_num: int = 8

    @classmethod
    def from_dict(cls, h: dict, use_nsf: bool = False):
        return cls(
            num_mels=int(h.get("num_mels", h.get("audio_num_mel_bins", 80))),
            upsample_initial_channel=int(h["upsample_initial_channel"]),
            upsample_rates=tuple(h["upsample_rates"]),
            upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
            resblock=str(h.get("resblock", "1")),
            resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(tuple(d) for d in
                                          h["resblock_dilation_sizes"]),
            sampling_rate=int(h.get("sampling_rate",
                                    h.get("audio_sample_rate", 24000))),
            use_nsf=use_nsf)


def stage_channels(cfg: HifiGanConfig, i: int) -> int:
    return cfg.upsample_initial_channel // (2 ** (i + 1))


# ---------------------------------------------------------------------------
# NSF source
# ---------------------------------------------------------------------------

def draw_randoms(batch: int, length: int, harmonic_num: int,
                 generator: Optional[torch.Generator] = None,
                 device=None):
    """(rand_ini [B, H+1] ~ U[0,1), unit_noise [B, H+1, L] ~ N(0,1))."""
    h = harmonic_num + 1
    rand_ini = torch.rand((batch, h), generator=generator, device=device)
    unit_noise = torch.randn((batch, h, length), generator=generator,
                             device=device)
    return rand_ini, unit_noise


def sine_gen_ht_from_randoms(rand_ini, unit_noise, f0_up, sr: int,
                             harmonic_num: int = 8, sine_amp: float = 0.1,
                             noise_std: float = 0.003,
                             voiced_threshold: float = 0.0):
    """Harmonic sine source from sample-rate f0 [B, L] in [B, H, L] layout:
    cumulative-sum phase with the reference's mod-1 overflow correction
    (models.py:183-213).  Returns (source [B, H, L], uv [B, 1, L])."""
    h = harmonic_num + 1
    harm = torch.arange(1, h + 1, dtype=f0_up.dtype, device=f0_up.device)
    rad = torch.remainder(f0_up[:, None, :] * harm[None, :, None] / sr, 1.0)
    rand_ini = rand_ini * (torch.arange(h, device=rad.device) > 0).to(rad.dtype)
    rad = torch.cat([rad[:, :, :1] + rand_ini[:, :, None], rad[:, :, 1:]], 2)
    tmp_over_one = torch.remainder(torch.cumsum(rad, dim=2), 1.0)
    wrap = (tmp_over_one[:, :, 1:] - tmp_over_one[:, :, :-1]) < 0
    shift = torch.cat([torch.zeros_like(rad[:, :, :1]),
                       torch.where(wrap, -1.0, 0.0).to(rad.dtype)], dim=2)
    phase = torch.cumsum(rad + shift, dim=2)
    sines = torch.sin(2.0 * np.pi * phase) * sine_amp
    uv = (f0_up[:, None, :] > voiced_threshold).to(rad.dtype)
    noise_amp = uv * noise_std + (1.0 - uv) * sine_amp / 3.0
    return sines * uv + noise_amp * unit_noise, uv


def source_module_from_randoms(l_linear: nn.Linear, rand_ini, unit_noise,
                               f0_up, sr: int, harmonic_num: int = 8):
    """SourceModuleHnNSF: merge harmonics -> tanh(linear) [B, L, 1]."""
    sines, _ = sine_gen_ht_from_randoms(rand_ini, unit_noise, f0_up, sr,
                                        harmonic_num)
    w = l_linear.weight[0]
    har = torch.tanh(torch.einsum("bhl,h->bl", sines, w) + l_linear.bias[0])
    return har[:, :, None]


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """torch.nn.Upsample(scale_factor=f) default 'nearest' on [B, T]."""
    return x[:, :, None].expand(*x.shape, factor).reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# Generator module
# ---------------------------------------------------------------------------

class ResBlock1(nn.Module):
    def __init__(self, ch: int, k: int, dilations: Sequence[int]):
        super().__init__()
        self.convs1 = nn.ModuleList([
            nn.Conv1d(ch, ch, k, dilation=d, padding=(k * d - d) // 2)
            for d in dilations])
        self.convs2 = nn.ModuleList([
            nn.Conv1d(ch, ch, k, padding=(k - 1) // 2) for _ in dilations])


class ResBlock2(nn.Module):
    def __init__(self, ch: int, k: int, dilations: Sequence[int]):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv1d(ch, ch, k, dilation=d, padding=(k * d - d) // 2)
            for d in dilations])


class SourceModule(nn.Module):
    def __init__(self, harmonic_num: int):
        super().__init__()
        self.l_linear = nn.Linear(harmonic_num + 1, 1)


class Generator(nn.Module):
    def __init__(self, cfg: HifiGanConfig):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, c0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        block = ResBlock1 if cfg.resblock == "1" else ResBlock2
        ch = c0
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            c_cur = stage_channels(cfg, i)
            self.ups.append(nn.ConvTranspose1d(ch, c_cur, k, u,
                                               padding=(k - u) // 2))
            if cfg.use_nsf:
                if i + 1 < len(cfg.upsample_rates):
                    s = int(np.prod(cfg.upsample_rates[i + 1:]))
                    self.noise_convs.append(nn.Conv1d(1, c_cur, s * 2,
                                                      stride=s,
                                                      padding=s // 2))
                else:
                    self.noise_convs.append(nn.Conv1d(1, c_cur, 1))
            for k_rb, d_rb in zip(cfg.resblock_kernel_sizes,
                                  cfg.resblock_dilation_sizes):
                self.resblocks.append(block(c_cur, k_rb, d_rb))
            ch = c_cur
        if cfg.use_nsf:
            self.m_source = SourceModule(cfg.harmonic_num)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)
        self._plans = {}

    def tail_plan(self, s0: int) -> vocoder_tail.TailPlan:
        """K3's static plan from stage s0 through conv_post (cached until a
        weight changes)."""
        version = tuple(p._version for p in self.parameters())
        key = (s0, self.conv_post.weight.device)
        hit = self._plans.get(key)
        if hit is None or hit[0] != version:
            hit = (version, build_tail_plan(self, s0))
            self._plans[key] = hit
        return hit[1]


def _stage_blocks(gen: Generator, i: int):
    n = len(gen.cfg.resblock_kernel_sizes)
    return [gen.resblocks[i * n + j] for j in range(n)]


def _resblock(blk: nn.Module, x: torch.Tensor, kind: str) -> torch.Tensor:
    """One resblock on channels-first [B, C, T] (reference math)."""
    if kind == "1":
        for c1, c2 in zip(blk.convs1, blk.convs2):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)),
                                 LRELU_SLOPE))
            x = xt + x
    else:
        for c in blk.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
    return x


def _upsample_stage(gen: Generator, i: int, x: torch.Tensor,
                    har: Optional[torch.Tensor]) -> torch.Tensor:
    """leaky -> ConvT -> + NSF injection, channels-first."""
    x = gen.ups[i](F.leaky_relu(x, LRELU_SLOPE))
    if har is not None:
        x = x + gen.noise_convs[i](har)[:, :, : x.shape[-1]]
    return x


def _resblock_mean(gen: Generator, i: int, x: torch.Tensor) -> torch.Tensor:
    xs = None
    for blk in _stage_blocks(gen, i):
        y = _resblock(blk, x, gen.cfg.resblock)
        xs = y if xs is None else xs + y
    return xs / len(gen.cfg.resblock_kernel_sizes)


def harmonic_source(gen: Generator, f0: torch.Tensor, randoms):
    """NSF source [B, 1, L] (channels-first) from frame f0 [B, T] in Hz."""
    cfg = gen.cfg
    f0_up = upsample_nearest(f0, int(np.prod(cfg.upsample_rates)))
    rand_ini, unit_noise = randoms
    har = source_module_from_randoms(gen.m_source.l_linear, rand_ini,
                                     unit_noise, f0_up, cfg.sampling_rate,
                                     cfg.harmonic_num)
    return har.transpose(1, 2)


def apply(gen: Generator, mel: torch.Tensor, f0=None, randoms=None):
    """Plain generator: mel [B, T, M] (ln-mel for NSF weights), f0 [B, T]
    Hz, randoms from :func:`draw_randoms` at length T*prod(rates).
    Returns wav [B, T*prod(rates)]."""
    har = None
    if gen.cfg.use_nsf and f0 is not None:
        har = harmonic_source(gen, f0, randoms)
    return apply_conv_stack(gen, mel, har)


def apply_conv_stack(gen: Generator, mel: torch.Tensor, har=None):
    """The deterministic conv stack given the NSF source [B, 1, L] (cuDNN's
    convolutions in true f32)."""
    with true_f32_convs():
        x = gen.conv_pre(mel.transpose(1, 2))
        for i in range(len(gen.cfg.upsample_rates)):
            x = _upsample_stage(gen, i, x, har)
            x = _resblock_mean(gen, i, x)
        x = gen.conv_post(F.leaky_relu(x))
    return torch.tanh(x)[:, 0, :]


def tail_start_stage(cfg: HifiGanConfig) -> int:
    """First stage K3 owns: the first stage of at most 128 channels (the
    TPU kernel's ``kernel_start_stage`` on the shipped geometries), else the
    last stage."""
    for i in range(len(cfg.upsample_rates)):
        if stage_channels(cfg, i) <= 128:
            return i
    return len(cfg.upsample_rates) - 1


def build_tail_plan(gen: Generator, s0: int) -> vocoder_tail.TailPlan:
    cfg = gen.cfg
    stages = []
    for i in range(s0, len(cfg.upsample_rates)):
        u, k = cfg.upsample_rates[i], cfg.upsample_kernel_sizes[i]
        convt = None if i == s0 else vocoder_tail.convt_plan(
            gen.ups[i], u, (k - u) // 2)
        branches = []
        for blk, k_rb, d_rb in zip(_stage_blocks(gen, i),
                                   cfg.resblock_kernel_sizes,
                                   cfg.resblock_dilation_sizes):
            convs = []
            if cfg.resblock == "1":
                for c1, c2, d in zip(blk.convs1, blk.convs2, d_rb):
                    convs.append(vocoder_tail.conv_plan(c1, d,
                                                        (k_rb * d - d) // 2))
                    convs.append(vocoder_tail.conv_plan(c2, 1,
                                                        (k_rb - 1) // 2))
            else:
                for c, d in zip(blk.convs, d_rb):
                    convs.append(vocoder_tail.conv_plan(c, d,
                                                        (k_rb * d - d) // 2))
            branches.append(tuple(convs))
        stages.append(vocoder_tail.StagePlan(
            convt, cfg.use_nsf and i > s0, cfg.resblock, tuple(branches)))
    k_post = gen.conv_post.weight.shape[-1]
    post = vocoder_tail.conv_plan(gen.conv_post, 1, (k_post - 1) // 2)
    return vocoder_tail.TailPlan(s0, tuple(stages), post)


def tail_prologue(gen: Generator, mel: torch.Tensor, har, s0: int):
    """conv_pre + stages before s0 in full + stage s0's leaky/ConvT/NSF
    injection, plain torch.  Returns x [B, T_s0, C_s0] (channels-last)."""
    x = gen.conv_pre(mel.transpose(1, 2))
    for i in range(s0 + 1):
        x = _upsample_stage(gen, i, x, har)
        if i < s0:
            x = _resblock_mean(gen, i, x)
    return x.transpose(1, 2).contiguous()


def apply_serving(gen: Generator, mel: torch.Tensor, f0=None, randoms=None):
    """Serving forward: plain-torch prologue + the K3 tail.  Same inputs and
    output as :func:`apply`; the prologue's and the NSF noise convs' cuDNN
    convolutions run in true f32 whatever the caller's TF32 flag."""
    cfg = gen.cfg
    s0 = tail_start_stage(cfg)
    har = None
    if cfg.use_nsf and f0 is not None:
        har = harmonic_source(gen, f0, randoms)
    with true_f32_convs():
        x = tail_prologue(gen, mel, har, s0)
        injs = None
        if har is not None:
            injs = [gen.noise_convs[i](har).transpose(1, 2).contiguous()
                    for i in range(s0 + 1, len(cfg.upsample_rates))]
    return vocoder_tail.tail(x, injs, gen.tail_plan(s0))
