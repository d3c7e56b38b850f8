"""HiFi-GAN's discriminators and the GAN losses (vocoder training).

Counterpart of ``diffsvc_tpu/vocoders/discriminators.py:20-222``
(reference ``modules/hifigan/hifigan.py:181-365``,
``modules/nsf_hifigan/models.py:398-548``): the multi-period discriminator
(periods 2, 3, 5, 7, 11) and the multi-scale one (three scales, the first
spectrally normalized), LSGAN losses and feature matching.

The reparameterizations are the JAX package's, not torch's:
- weight norm: w = g * v / sqrt(sum(v^2) + 1e-12), the sum per output
  channel over (in, k) (:class:`WNConv1d`, leaves ``weight_v`` [out, in,
  k] and ``weight_g`` [out]);
- spectral norm: w / sigma, sigma from 5 power iterations started at
  u = 1/sqrt(out) on every forward, the vectors outside the gradient
  (:class:`SNConv1d`, leaf ``weight_bar``).  ``torch.nn.utils.
  spectral_norm`` keeps a random persistent u and runs one iteration a
  forward: other numbers.

The period discriminators fold the period into the batch and run 1-D
convolutions on the folded axis, as the JAX package does (the reference's
(k, 1) Conv2d computes the same).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1
PERIODS = (2, 3, 5, 7, 11)


def _get_padding(k: int, d: int = 1) -> int:
    return (k * d - d) // 2


class _ReparamConv1d(nn.Module):
    """A Conv1d's geometry and bias (torch's default init); its weight is
    stored as :meth:`_reparam` makes it and read through :meth:`weight`."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 padding: int = 0, groups: int = 1):
        super().__init__()
        conv = nn.Conv1d(c_in, c_out, k, stride, padding, groups=groups)
        self.stride, self.padding, self.groups = stride, padding, groups
        self.bias = conv.bias
        self._reparam(conv.weight.detach())

    def forward(self, x):
        return F.conv1d(x, self.weight(), self.bias, self.stride,
                        self.padding, groups=self.groups)


class WNConv1d(_ReparamConv1d):
    def _reparam(self, w):
        self.weight_v = nn.Parameter(w.clone())
        self.weight_g = nn.Parameter(torch.sqrt((w ** 2).sum((1, 2)) + 1e-12))

    def weight(self):
        v = self.weight_v
        norm = torch.sqrt((v ** 2).sum((1, 2), keepdim=True) + 1e-12)
        return v / norm * self.weight_g[:, None, None]


class SNConv1d(_ReparamConv1d):
    N_ITER = 5

    def _reparam(self, w):
        self.weight_bar = nn.Parameter(w.clone())

    def weight(self):
        w = self.weight_bar
        m = w.reshape(w.shape[0], -1).t()          # [in * k, out]
        with torch.no_grad():
            u = torch.full((m.shape[1],), m.shape[1] ** -0.5,
                           dtype=m.dtype, device=m.device)
            for _ in range(self.N_ITER):
                v = m @ u
                v = v / (torch.linalg.norm(v) + 1e-12)
                u = m.t() @ v
                u = u / (torch.linalg.norm(u) + 1e-12)
            mu = m @ u
            v = mu / (torch.linalg.norm(mu) + 1e-12)
        return w / (v @ (m @ u))


# ---------------------------------------------------------------------------
# Multi-period discriminator
# ---------------------------------------------------------------------------

MPD_CHANNELS = ((1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024))


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = _get_padding(5, 1)
        self.convs = nn.ModuleList(
            WNConv1d(ci, co, kernel_size, stride if i < 4 else 1, pad)
            for i, (ci, co) in enumerate(MPD_CHANNELS))
        self.conv_post = WNConv1d(MPD_CHANNELS[-1][1], 1, 3, padding=1)

    def forward(self, x):
        """x [B, T] -> (score [B, n], the feature maps)."""
        b, t = x.shape
        p = self.period
        if t % p:
            x = F.pad(x[:, None], (0, p - t % p), mode="reflect")[:, 0]
            t = x.shape[1]
        h = x.reshape(b, t // p, p).transpose(1, 2).reshape(b * p, 1, t // p)
        fmap = []
        for c in self.convs:
            h = F.leaky_relu(c(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(b, -1), fmap


def _pairs(discs, y, y_hat, pool=None):
    rs, gs, fr, fg = [], [], [], []
    for i, d in enumerate(discs):
        if pool is not None and i > 0:
            y, y_hat = pool(y), pool(y_hat)
        r, fmap_r = d(y)
        g, fmap_g = d(y_hat)
        rs.append(r)
        gs.append(g)
        fr.append(fmap_r)
        fg.append(fmap_g)
    return rs, gs, fr, fg


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p)
                                            for p in PERIODS)
        self.to(device)

    def forward(self, y, y_hat):
        """(real scores, generated scores, real fmaps, generated fmaps)."""
        return _pairs(self.discriminators, y, y_hat)


# ---------------------------------------------------------------------------
# Multi-scale discriminator
# ---------------------------------------------------------------------------

MSD_SPECS = (  # (kernel, stride, groups, c_in, c_out)
    (15, 1, 1, 1, 128), (41, 2, 4, 128, 128), (41, 2, 16, 128, 256),
    (41, 4, 16, 256, 512), (41, 4, 16, 512, 1024), (41, 1, 16, 1024, 1024),
    (5, 1, 1, 1024, 1024))


class DiscriminatorS(nn.Module):
    def __init__(self, use_spectral_norm: bool = False):
        super().__init__()
        conv = SNConv1d if use_spectral_norm else WNConv1d
        self.convs = nn.ModuleList(conv(ci, co, k, s, k // 2, g)
                                   for k, s, g, ci, co in MSD_SPECS)
        self.conv_post = conv(MSD_SPECS[-1][4], 1, 3, padding=1)

    def forward(self, x):
        h = x[:, None, :]
        fmap = []
        for c in self.convs:
            h = F.leaky_relu(c(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(h.shape[0], -1), fmap


def _avg_pool(x):
    """AvgPool1d(4, 2, padding=2), divisor 4 at the padded edges too
    (reference models.py:494-497)."""
    return F.avg_pool1d(x[:, None], 4, 2, padding=2)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, n_scales: int = 3, device=None):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorS(use_spectral_norm=(i == 0))
            for i in range(n_scales))
        self.to(device)

    def forward(self, y, y_hat):
        return _pairs(self.discriminators, y, y_hat, pool=_avg_pool)


# ---------------------------------------------------------------------------
# Losses (reference models.py:509-548)
# ---------------------------------------------------------------------------

def feature_loss(fmap_r, fmap_g):
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.abs(rl - gl).mean()
    return loss * 2.0


def discriminator_loss(disc_real, disc_generated):
    loss = 0.0
    for dr, dg in zip(disc_real, disc_generated):
        loss = loss + ((1 - dr) ** 2).mean() + (dg ** 2).mean()
    return loss


def generator_loss(disc_outputs):
    loss = 0.0
    for dg in disc_outputs:
        loss = loss + ((1 - dg) ** 2).mean()
    return loss
