"""NSF source-signal variants: the pulse train and the cyclic noise.

Counterpart of ``diffsvc_tpu/vocoders/source.py:12-93`` (reference
``modules/parallel_wavegan/models/source.py``: PulseGen, CyclicNoiseGen_v1,
SourceModuleCycNoise_v1).  The JAX functions draw from a key; these take
the unit-normal draws themselves (:func:`draw_cyc_noise`, or a
``torch.Generator``), so two implementations can be fed the same ones.
No runtime path calls them, in either package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def pulse_gen(f0_up: torch.Tensor, sr: int, unit_noise: torch.Tensor,
              pulse_amp: float = 0.1, noise_std: float = 0.003):
    """One pulse per period (at the phase-wrap grid) plus an onset pulse
    where voicing starts; noise ``unit_noise * noise_std`` added at the
    pulses and in unvoiced regions only (source.py:140-202).

    f0_up [B, L] at the sample rate.  Returns (pulse_train, uv, noise)."""
    rad = f0_up / sr
    phase = torch.remainder(torch.cumsum(rad, dim=1), 1.0)
    wrap = torch.cat([torch.ones_like(phase[:, :1], dtype=torch.bool),
                      phase[:, 1:] < phase[:, :-1]], dim=1)
    uv = f0_up > 0
    uv_prev = torch.cat([torch.zeros_like(uv[:, :1]), uv[:, :-1]], dim=1)
    loc = ((wrap | (uv & ~uv_prev)) & uv).to(f0_up.dtype)
    uvf = uv.to(f0_up.dtype)
    noise = unit_noise * noise_std
    return loc * pulse_amp + noise * (loc + (1.0 - uvf)), uvf, noise


def kernel_length(sr: int, f0_floor: float = 40.0) -> int:
    """The cyclic-noise kernel's static length (its -40 dB point at the
    f0 floor)."""
    return int(4.6 * sr / f0_floor) + 1


def cyclic_noise_gen(f0_up: torch.Tensor, sr: int, pulse_noise: torch.Tensor,
                     kern_noise: torch.Tensor, noise_std: float = 0.003,
                     beta: float = 0.87, f0_floor: float = 40.0):
    """Cyclic noise v1 (source.py:246-308): one random kernel
    n[t] exp(-t f0_mean / (beta sr)), cut at -40 dB, convolved causally
    with the noise-free pulse train, plus plain noise where unvoiced.

    ``pulse_noise`` [B, L] and ``kern_noise`` [kernel_length] are unit
    normal.  Returns (cyclic_noise, uv)."""
    pulse_train, uv, noise = pulse_gen(f0_up, sr, pulse_noise,
                                       pulse_amp=1.0, noise_std=noise_std)
    # the reference's quirk kept: the noise field is subtracted everywhere
    pure_pulse = pulse_train - noise
    f0_mean = (f0_up * uv).sum(1) / torch.clamp(uv.sum(1), min=1.0)
    f0_mean = torch.clamp(f0_mean, min=f0_floor)
    n_k = kern_noise.shape[0]
    t = torch.arange(n_k, dtype=f0_up.dtype, device=f0_up.device)
    fm = f0_mean[:, None]
    decay = torch.exp(-t * fm / beta / sr) * (t < 4.6 * sr / fm).to(
        f0_up.dtype)
    kern = kern_noise * noise_std * decay                     # [B, n_k]
    b, length = pure_pulse.shape
    # the causal convolution's first L samples, one kernel per row
    cyc = F.conv1d(F.pad(pure_pulse, (n_k - 1, 0))[None],
                   kern.flip(-1)[:, None, :], groups=b)[0, :, :length]
    return cyc + noise * (1.0 - uv), uv


def draw_cyc_noise(batch: int, length: int, sr: int, f0_floor: float = 40.0,
                   generator: Optional[torch.Generator] = None, device=None):
    """(pulse_noise [B, L], kern_noise [kernel_length], branch_noise
    [B, L]), unit normal: the draws of :func:`source_module_cyc_noise`."""
    kw = dict(generator=generator, device=device)
    return (torch.randn((batch, length), **kw),
            torch.randn((kernel_length(sr, f0_floor),), **kw),
            torch.randn((batch, length), **kw))


def source_module_cyc_noise(f0_up: torch.Tensor, sr: int, draws,
                            noise_std: float = 0.003, beta: float = 0.87,
                            voiced_threshold: float = 0.0):
    """SourceModuleCycNoise_v1 (source.py:444-483): (cyc, noise, uv), each
    [B, L]: the cyclic noise of f0 above ``voiced_threshold``, a Gaussian
    branch scaled ``noise_std / 3`` and the voiced mask.  ``draws`` are
    :func:`draw_cyc_noise`'s."""
    pulse_noise, kern_noise, branch_noise = draws
    f0_gated = torch.where(f0_up > voiced_threshold, f0_up,
                           torch.zeros_like(f0_up))
    cyc, uv = cyclic_noise_gen(f0_gated, sr, pulse_noise, kern_noise,
                               noise_std=noise_std, beta=beta)
    return cyc, branch_noise * noise_std / 3.0, uv
