"""The three networks as plain functions of a state dict, f32: HuBERT-soft
(bshall/hubert), diff-svc's conditioner (``no_fs2``) and DiffNet
(``network/diff/net.py``) with the PLMS sampler (``diffusion.py``), and the
openvpi NSF-HiFiGAN generator with its harmonic source.  Every product goes
through :mod:`.precision`, tagged with the part it belongs to.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import dsp
from .params import HUBERT_CONVS, noise_conv_geometry
from .precision import conv1d, conv_transpose1d, linear, q

# ---------------------------------------------------------------- HuBERT


def hubert_units(sd: dict, wav16: torch.Tensor, cfg: dict) -> torch.Tensor:
    """[L] 16 kHz -> soft units [T, proj_dim]; the wave padded by 40
    samples on each side as HubertSoft.units does."""
    part = "hubert"
    x = F.pad(wav16.float(), (40, 40))[None, None]
    x = conv1d(x, sd["feature_extractor.conv0.weight"], None, part, stride=5)
    x = F.gelu(F.group_norm(x, 512, sd["feature_extractor.norm0.weight"],
                            sd["feature_extractor.norm0.bias"]))
    for i in range(1, 7):
        x = F.gelu(conv1d(x, sd[f"feature_extractor.conv{i}.weight"], None,
                          part, stride=HUBERT_CONVS[i][1]))
    x = x.transpose(1, 2)
    x = F.layer_norm(x, (512,), sd["feature_projection.norm.weight"],
                     sd["feature_projection.norm.bias"])
    x = linear(x, sd["feature_projection.projection.weight"],
               sd["feature_projection.projection.bias"], part)
    pos = conv1d(x.transpose(1, 2), sd["positional_embedding.conv.weight"],
                 sd["positional_embedding.conv.bias"], part, padding=64,
                 groups=16)[:, :, :-1]
    dim = int(cfg["dim"])
    x = F.layer_norm(x + F.gelu(pos).transpose(1, 2), (dim,),
                     sd["norm.weight"], sd["norm.bias"])
    heads = int(cfg["num_heads"])
    hd = dim // heads
    t = x.shape[1]
    for i in range(int(cfg["num_layers"])):
        e = f"encoder.layers.{i}"
        qkv = linear(x, sd[f"{e}.self_attn.in_proj_weight"],
                     sd[f"{e}.self_attn.in_proj_bias"], part)
        qh, kh, vh = (a.reshape(1, t, heads, hd).transpose(1, 2)
                      for a in qkv.chunk(3, -1))
        att = torch.softmax(q(qh, part) @ q(kh, part).transpose(-1, -2)
                            / math.sqrt(hd), dim=-1)
        a = (q(att, part) @ q(vh, part)).transpose(1, 2).reshape(1, t, dim)
        a = linear(a, sd[f"{e}.self_attn.out_proj.weight"],
                   sd[f"{e}.self_attn.out_proj.bias"], part)
        x = F.layer_norm(x + a, (dim,), sd[f"{e}.norm1.weight"],
                         sd[f"{e}.norm1.bias"])
        h = F.gelu(linear(x, sd[f"{e}.linear1.weight"],
                          sd[f"{e}.linear1.bias"], part))
        h = linear(h, sd[f"{e}.linear2.weight"], sd[f"{e}.linear2.bias"],
                   part)
        x = F.layer_norm(x + h, (dim,), sd[f"{e}.norm2.weight"],
                         sd[f"{e}.norm2.bias"])
    return linear(x, sd["proj.weight"], sd["proj.bias"], part)[0]


# ------------------------------------------------------------ conditioner

def condition(sd: dict, hp: dict, units: torch.Tensor, mel2ph: torch.Tensor,
              f0n: torch.Tensor):
    """(decoder input [B, T, H], f0 in Hz [B, T]) of diff-svc's no_fs2
    encoder: the frame-aligned units [B, T_u, H] plus the pitch embedding
    of the de-normalized f0 (2^f0, 0 on padding frames), zero on padding
    frames (mel2ph 0)."""
    pad = mel2ph == 0
    f0 = torch.where(pad, torch.zeros_like(f0n), 2.0 ** f0n)
    padded = F.pad(units, (0, 0, 1, 0))
    x = torch.gather(padded, 1, mel2ph.long()[:, :, None].expand(
        -1, -1, units.shape[-1]))
    x = x + sd["fs2.pitch_embed.weight"][dsp.f0_to_coarse(
        f0, int(hp["f0_bin"]), float(hp["f0_min"]), float(hp["f0_max"]))]
    return x * (~pad)[:, :, None].float(), f0


# ---------------------------------------------------------------- DiffNet

def betas(hp: dict) -> np.ndarray:
    k = int(hp["timesteps"])
    if hp.get("schedule_type", "cosine") == "linear":
        return np.linspace(1e-4, float(hp["max_beta"]), k)
    x = np.linspace(0, k + 1, k + 1)
    ac = np.cos(((x / (k + 1)) + 0.008) / 1.008 * np.pi * 0.5) ** 2
    return np.clip(1 - ac[1:] / ac[:-1], 0, 0.999)


def alphas_cumprod(hp: dict) -> np.ndarray:
    return np.cumprod(1.0 - betas(hp)).astype(np.float32)


def _step_embedding(sd: dict, t: torch.Tensor, c: int) -> torch.Tensor:
    """Sinusoidal embedding of the steps t [B] through the step MLP
    (Linear C -> 4C, Mish, Linear 4C -> C): [B, C]."""
    half = c // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    a = t.float()[:, None] * freqs[None]
    e = torch.cat([torch.sin(a), torch.cos(a)], dim=-1)
    d = "denoise_fn"
    e = linear(e, sd[f"{d}.mlp.0.weight"], sd[f"{d}.mlp.0.bias"], "denoiser")
    e = e * torch.tanh(F.softplus(e))
    return linear(e, sd[f"{d}.mlp.2.weight"], sd[f"{d}.mlp.2.bias"],
                  "denoiser")


def cond_projections(sd: dict, hp: dict, cond: torch.Tensor) -> list:
    """Each layer's 1x1 conditioner projection [B, 2C, T] of cond [B, T, H]
    (once per clip; the conditioner's part)."""
    c_t = cond.transpose(1, 2)
    d = "denoise_fn.residual_layers"
    return [conv1d(c_t, sd[f"{d}.{i}.conditioner_projection.weight"],
                   sd[f"{d}.{i}.conditioner_projection.bias"], "conditioner")
            for i in range(int(hp["residual_layers"]))]


def diffnet(sd: dict, hp: dict, spec: torch.Tensor, t: torch.Tensor,
            cps: list) -> torch.Tensor:
    """Noise prediction [B, T, M] of the noisy mel ``spec`` [B, T, M] at
    steps t [B]: 1x1 in -> ReLU -> L gated residual blocks (dilated k=3
    conv, dilation 2^(i % cycle); (x + residual) / sqrt 2) -> skip sum /
    sqrt L -> 1x1 -> ReLU -> 1x1."""
    d, part = "denoise_fn", "denoiser"
    c, n_layers = int(hp["residual_channels"]), int(hp["residual_layers"])
    cycle = int(hp["dilation_cycle_length"])
    x = F.relu(conv1d(spec.transpose(1, 2),
                      sd[f"{d}.input_projection.weight"],
                      sd[f"{d}.input_projection.bias"], part))
    step = _step_embedding(sd, t, c)
    skip = 0.0
    for i in range(n_layers):
        r = f"{d}.residual_layers.{i}"
        dil = 2 ** (i % cycle)
        s = linear(step, sd[f"{r}.diffusion_projection.weight"],
                   sd[f"{r}.diffusion_projection.bias"], part)
        y = conv1d(x + s[:, :, None], sd[f"{r}.dilated_conv.weight"],
                   sd[f"{r}.dilated_conv.bias"], part, padding=dil,
                   dilation=dil) + cps[i]
        gate, filt = y.chunk(2, dim=1)
        y = torch.sigmoid(gate) * torch.tanh(filt)
        y = conv1d(y, sd[f"{r}.output_projection.weight"],
                   sd[f"{r}.output_projection.bias"], part)
        res, sk = y.chunk(2, dim=1)
        x = (x + res) / math.sqrt(2.0)
        skip = skip + sk
    x = skip / math.sqrt(n_layers)
    x = F.relu(conv1d(x, sd[f"{d}.skip_projection.weight"],
                      sd[f"{d}.skip_projection.bias"], part))
    x = conv1d(x, sd[f"{d}.output_projection.weight"],
               sd[f"{d}.output_projection.bias"], part)
    return x.transpose(1, 2)


def plms(sd: dict, hp: dict, x: torch.Tensor, cond: torch.Tensor,
         interval: int) -> torch.Tensor:
    """PLMS (PNDM) of x [B, T, M] from K_step down to 0 every ``interval``
    steps, the Adams-Bashforth order ramp 1 -> 4 and the first step's
    double evaluation (diff-svc ``diffusion.py``'s ``p_sample_plms``)."""
    ac = torch.from_numpy(alphas_cumprod(hp)).to(x.device)
    cps = cond_projections(sd, hp, cond)

    def eps_at(xx, t):
        tb = torch.full((xx.shape[0],), t, dtype=torch.long, device=x.device)
        return diffnet(sd, hp, xx, tb, cps)

    def x_pred(xx, e, t):
        a_t, a_p = ac[t], ac[max(t - interval, 0)]
        at_s, ap_s = torch.sqrt(a_t), torch.sqrt(a_p)
        return xx + (a_p - a_t) * (
            (1.0 / (at_s * (at_s + ap_s))) * xx
            - 1.0 / (at_s * (torch.sqrt((1 - a_p) * a_t)
                             + torch.sqrt((1 - a_t) * a_p))) * e)

    n_steps = max(-(-int(hp["K_step"]) // interval), 1)
    hist = []
    for k in range(n_steps):
        t = (n_steps - 1 - k) * interval
        e = eps_at(x, t)
        if not hist:
            xp = x_pred(x, e, t)
            e_prime = (e + eps_at(xp, max(t - interval, 0))) / 2.0
        elif len(hist) == 1:
            e_prime = (3.0 * e - hist[0]) / 2.0
        elif len(hist) == 2:
            e_prime = (23.0 * e - 16.0 * hist[0] + 5.0 * hist[1]) / 12.0
        else:
            e_prime = (55.0 * e - 59.0 * hist[0] + 37.0 * hist[1]
                       - 9.0 * hist[2]) / 24.0
        x = x_pred(x, e_prime, t)
        hist = [e] + hist[:2]
    return x


# ------------------------------------------------------------ NSF-HiFiGAN

def harmonic_source(sd: dict, voc: dict, f0: torch.Tensor, rand_ini,
                    unit_noise) -> torch.Tensor:
    """The NSF source [1, 1, L] of frame f0 [T] (Hz): nearest upsampling,
    the sine generator with its mod-1 phase correction, voiced/unvoiced
    noise, the harmonics merged by a linear layer and tanh."""
    up = int(np.prod(voc["upsample_rates"]))
    sr, h = int(voc["sampling_rate"]), int(voc["harmonic_num"]) + 1
    f0_up = f0[:, None].expand(-1, up).reshape(-1)[None]           # [1, L]
    harm = torch.arange(1, h + 1, dtype=torch.float32, device=f0.device)
    rad = torch.remainder(f0_up[:, None, :] * harm[None, :, None] / sr, 1.0)
    ini = rand_ini * (torch.arange(h, device=f0.device) > 0).float()
    rad = torch.cat([rad[:, :, :1] + ini[:, :, None], rad[:, :, 1:]], 2)
    over = torch.remainder(torch.cumsum(rad, dim=2), 1.0)
    wrap = (over[:, :, 1:] - over[:, :, :-1]) < 0
    shift = torch.cat([torch.zeros_like(rad[:, :, :1]),
                       torch.where(wrap, -1.0, 0.0)], dim=2)
    sines = torch.sin(2.0 * np.pi * torch.cumsum(rad + shift, dim=2)) * 0.1
    uv = (f0_up[:, None, :] > 0).float()
    src = sines * uv + (uv * 0.003 + (1.0 - uv) * 0.1 / 3.0) * unit_noise
    w, b = sd["m_source.l_linear.weight"][0], sd["m_source.l_linear.bias"][0]
    return torch.tanh(torch.einsum("bhl,h->bl", src, w) + b)[:, None, :]


def generator(sd: dict, voc: dict, mel_ln: torch.Tensor, har) -> torch.Tensor:
    """wav [T * prod(rates)] of an ln-mel [T, M] and the NSF source."""
    part = "vocoder"
    x = conv1d(mel_ln.T[None], sd["conv_pre.weight"], sd["conv_pre.bias"],
               part, padding=3)
    n_k = len(voc["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(voc["upsample_rates"],
                                   voc["upsample_kernel_sizes"])):
        x = conv_transpose1d(F.leaky_relu(x, 0.1), sd[f"ups.{i}.weight"],
                             sd[f"ups.{i}.bias"], part, stride=int(u),
                             padding=(int(k) - int(u)) // 2)
        kn, sn, pn = noise_conv_geometry(voc, i)
        x = x + conv1d(har, sd[f"noise_convs.{i}.weight"],
                       sd[f"noise_convs.{i}.bias"], part, stride=sn,
                       padding=pn)[:, :, : x.shape[-1]]
        acc = 0.0
        for j, (k_rb, d_rb) in enumerate(zip(voc["resblock_kernel_sizes"],
                                             voc["resblock_dilation_sizes"])):
            y = x
            rb = f"resblocks.{i * n_k + j}"
            for n, dil in enumerate(d_rb):
                xt = conv1d(F.leaky_relu(y, 0.1), sd[f"{rb}.convs1.{n}.weight"],
                            sd[f"{rb}.convs1.{n}.bias"], part,
                            padding=(k_rb * dil - dil) // 2, dilation=dil)
                xt = conv1d(F.leaky_relu(xt, 0.1), sd[f"{rb}.convs2.{n}.weight"],
                            sd[f"{rb}.convs2.{n}.bias"], part,
                            padding=(k_rb - 1) // 2)
                y = xt + y
            acc = acc + y
        x = acc / n_k
    x = conv1d(F.leaky_relu(x), sd["conv_post.weight"], sd["conv_post.bias"],
               part, padding=3)
    return torch.tanh(x)[0, 0]
