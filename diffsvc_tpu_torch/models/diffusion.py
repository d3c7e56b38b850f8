"""Gaussian diffusion over normalized mel spectrograms.

Counterpart of ``diffsvc_tpu/models/diffusion.py`` (reference
``network/diff/diffusion.py``): the beta schedules and derived tables,
norm/denorm, q_sample, the training loss (``p_losses``,
``GaussianDiffusion.training_loss``, through K4), the DDPM, PLMS and
DPM-Solver++(2M) samplers, optional ``sampler_clip_x0``,
``GaussianDiffusion.infer`` and ``OfflineGaussianDiffusion``.

PLMS and DPM-Solver++ (``acc > 1``) run through K2
(``ops/hopper/plms_ladder.py``): every denoiser evaluation and the sampler
update as one table-driven program — the Hopper kernels for CUDA tensors,
their plain version for CPU tensors.  The FFT denoiser
(``diff_decoder_type: fft``, ``models/candidate_decoder.py``) is never
routed through the ladder, as in the JAX package: it samples with the
step-by-step samplers, in plain PyTorch on the card too.  The step-by-step samplers
:func:`p_sample_plms_scan` and :func:`p_sample_dpmpp_2m_scan` are the same
samplers written the way the reference writes them; the tests hold the
ladder against them.  DDPM (``acc <= 1``) is :func:`p_sample_ddpm_scan`:
one denoiser evaluation per step through :func:`diffnet.apply` (K1 on the
card) and the posterior update in plain torch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.hopper import plms_ladder as _pl
from . import diffnet
from .candidate_decoder import FFTDecoder
from .fs2 import FastSpeech2

DPMPP_NAMES = ("dpmpp", "dpm++", "dpm_solver")


def linear_beta_schedule(timesteps: int, max_beta: float = 0.01) -> np.ndarray:
    return np.linspace(1e-4, max_beta, timesteps)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def make_tables(timesteps: int, schedule_type: str = "cosine",
                 max_beta: float = 0.01) -> dict:
    """The derived schedule tables the samplers use (reference
    ``diffusion.py:100-123``), computed in float64 and stored float32
    (numpy) exactly like the JAX package."""
    if schedule_type == "linear":
        betas = linear_beta_schedule(timesteps, max_beta)
    else:
        betas = cosine_beta_schedule(timesteps)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    ac_prev = np.append(1.0, alphas_cumprod[:-1])
    post_var = betas * (1.0 - ac_prev) / (1.0 - alphas_cumprod)
    t = {
        "betas": betas,
        "alphas_cumprod": alphas_cumprod,
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
        "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / alphas_cumprod),
        "sqrt_recipm1_alphas_cumprod": np.sqrt(1.0 / alphas_cumprod - 1),
        "posterior_log_variance_clipped": np.log(np.maximum(post_var, 1e-20)),
        "posterior_mean_coef1": betas * np.sqrt(ac_prev)
        / (1.0 - alphas_cumprod),
        "posterior_mean_coef2": (1.0 - ac_prev) * np.sqrt(alphas)
        / (1.0 - alphas_cumprod),
    }
    return {k: v.astype(np.float32) for k, v in t.items()}


def norm_spec(x, spec_min, spec_max):
    return (x - spec_min) / (spec_max - spec_min) * 2.0 - 1.0


def denorm_spec(x, spec_min, spec_max):
    return (x + 1.0) / 2.0 * (spec_max - spec_min) + spec_min


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    out = table[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def q_sample(tables: dict, x_start, t, noise):
    """tables: torch float32 tensors on x_start's device; t: [B] int."""
    return (_extract(tables["sqrt_alphas_cumprod"], t, x_start.ndim) * x_start
            + _extract(tables["sqrt_one_minus_alphas_cumprod"], t,
                       x_start.ndim) * noise)


def p_losses(tables: dict, denoise_fn, x_start, t, noise,
             loss_type: str = "l2", nonpadding=None, sample_mask=None,
             count=None, own=None, frames: Optional[int] = None):
    """Diffusion training loss (``diffsvc_tpu/models/diffusion.py:116-149``,
    reference ``diffusion.py:205-225``) with the noise drawn by the caller.

    l1 is time-masked by ``nonpadding`` but not renormalized over it (the
    reference's semantics); ``sample_mask`` [B] marks real rows of a
    batch padded on its batch axis and renormalizes over them.  ``count``
    replaces the number of real rows, ``max(sum(sample_mask), 1)``: a
    data-parallel rank passes the global batch's, so that the ranks'
    losses sum to the global loss.

    ``own`` [T_w] (0 / 1) marks a seq rank's own frames of its window and
    ``frames`` is the global T: the loss is then those frames' share of
    the global loss, the sum of their (masked) errors over ``count`` (or
    the rows) times ``frames`` times M, since both losses take the mean
    over the whole padded T.  Without ``own`` the numbers are those of the
    unsharded loss, bit for bit."""
    x_recon = denoise_fn(q_sample(tables, x_start, t, noise), t)
    if loss_type not in ("l1", "l2"):
        raise NotImplementedError(loss_type)
    if own is not None:
        err = (noise - x_recon).abs() if loss_type == "l1" \
            else (noise - x_recon) ** 2
        if loss_type == "l1" and nonpadding is not None:
            err = err * nonpadding[:, :, None]
        err = err * own[None, :, None]
        if sample_mask is not None:
            err = err * sample_mask[:, None, None]
            if count is None:
                count = sample_mask.sum().clamp(min=1.0)
        elif count is None:
            count = err.shape[0]
        return err.sum() / (count * frames * err.shape[2])
    if loss_type == "l1":
        err = (noise - x_recon).abs()
        if nonpadding is not None:
            err = err * nonpadding[:, :, None]
        if sample_mask is None:
            return err.mean()
        err = err * sample_mask[:, None, None]
        if count is None:
            count = sample_mask.sum().clamp(min=1.0)
        return err.sum() / (count * err.shape[1] * err.shape[2])
    sq = (noise - x_recon) ** 2
    if sample_mask is None:
        return sq.mean()
    per_row = sq.mean(dim=(1, 2))
    if count is None:
        count = sample_mask.sum().clamp(min=1.0)
    return (per_row * sample_mask).sum() / count


def p_sample_ddpm_scan(tables: dict, denoise_fn, x, t_start: int, *,
                       step_noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       clip_denoised: bool = True):
    """Ancestral DDPM sampling from t_start-1 down to 0
    (``diffsvc_tpu/models/diffusion.py:156-179``): x0 predicted from the
    noise, clipped to [-1, 1], the posterior mean, plus the posterior
    deviation times fresh noise, masked at t=0.

    The noise of step k (t = t_start-1-k) is ``step_noise[k]`` when the
    caller passes ``step_noise`` [t_start, B, T, M] (a test shares JAX's
    draws; the fused program draws them outside its graph), else a draw
    from ``generator`` on x's device."""
    if step_noise is not None and step_noise.shape[0] != t_start:
        raise ValueError(f"step_noise has {step_noise.shape[0]} steps, the "
                         f"trajectory {t_start}")
    for k, t in enumerate(range(t_start - 1, -1, -1)):
        tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        noise_pred = denoise_fn(x, tb)
        x_recon = (_extract(tables["sqrt_recip_alphas_cumprod"], tb, x.ndim)
                   * x - _extract(tables["sqrt_recipm1_alphas_cumprod"], tb,
                                  x.ndim) * noise_pred)
        if clip_denoised:
            x_recon = torch.clamp(x_recon, -1.0, 1.0)
        mean = (_extract(tables["posterior_mean_coef1"], tb, x.ndim) * x_recon
                + _extract(tables["posterior_mean_coef2"], tb, x.ndim) * x)
        log_var = _extract(tables["posterior_log_variance_clipped"], tb,
                           x.ndim)
        noise = step_noise[k] if step_noise is not None else torch.randn(
            x.shape, generator=generator, device=x.device)
        nonzero = float(t > 0)
        x = mean + nonzero * torch.exp(0.5 * log_var) * noise
    return x


def clip_x0_closure(tables: dict, denoise_fn, clip_v: float):
    """``sampler_clip_x0`` around a denoiser (``diffsvc_tpu/models/
    diffusion.py:547-562``): the data prediction clamped to +-clip_v in
    the normalized spec domain, the noise rewritten to match."""
    def fn(x, t):
        eps = denoise_fn(x, t)
        a = _extract(tables["sqrt_alphas_cumprod"], t, x.ndim)
        s = torch.clamp(_extract(tables["sqrt_one_minus_alphas_cumprod"], t,
                                 x.ndim), min=1e-12)
        x0 = torch.clamp((x - s * eps) / torch.clamp(a, min=1e-12),
                         -clip_v, clip_v)
        return (x - a * x0) / s
    return fn


def _plms_x_pred(ac: torch.Tensor, x, noise_t, t: int, interval: int):
    """PLMS transfer function (reference diffusion.py:169-177)."""
    a_t = ac[t]
    a_prev = ac[max(t - interval, 0)]
    a_t_sq, a_prev_sq = torch.sqrt(a_t), torch.sqrt(a_prev)
    x_delta = (a_prev - a_t) * (
        (1.0 / (a_t_sq * (a_t_sq + a_prev_sq))) * x
        - 1.0 / (a_t_sq * (torch.sqrt((1 - a_prev) * a_t)
                           + torch.sqrt((1 - a_t) * a_prev))) * noise_t)
    return x + x_delta


def p_sample_plms_scan(tables: dict, denoise_fn, x, t_start: int,
                       interval: int):
    """PLMS/PNDM: steps over reversed(range(0, t_start, interval)) with the
    Adams-Bashforth order ramp 1->4 and the order-1 double evaluation."""
    ac = tables["alphas_cumprod"]
    n_steps = max(-(-t_start // interval), 1)
    hist = []   # newest first
    for k in range(n_steps):
        t = (n_steps - 1 - k) * interval
        tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        noise_pred = denoise_fn(x, tb)
        if not hist:
            x_pred = _plms_x_pred(ac, x, noise_pred, t, interval)
            tb_prev = torch.clamp(tb - interval, min=0)
            noise_prime = (noise_pred + denoise_fn(x_pred, tb_prev)) / 2.0
        elif len(hist) == 1:
            noise_prime = (3.0 * noise_pred - hist[0]) / 2.0
        elif len(hist) == 2:
            noise_prime = (23.0 * noise_pred - 16.0 * hist[0]
                           + 5.0 * hist[1]) / 12.0
        else:
            noise_prime = (55.0 * noise_pred - 59.0 * hist[0] + 37.0 * hist[1]
                           - 9.0 * hist[2]) / 24.0
        x = _plms_x_pred(ac, x, noise_prime, t, interval)
        hist = [noise_pred] + hist[:2]
    return x


def dpmpp_timesteps(ac_np: np.ndarray, t_start: int, interval: int,
                    grid: str = "lambda") -> np.ndarray:
    """The DPM-Solver++ visiting ladder (host numpy): descending timesteps
    from t_start-1 to 0, on the uniform log-SNR grid or the uniform-t one."""
    n_steps = max(-(-t_start // interval), 1)
    if grid == "lambda":
        lam_np = 0.5 * (np.log(ac_np) - np.log(np.maximum(1.0 - ac_np, 1e-12)))
        target = np.linspace(lam_np[t_start - 1], lam_np[0], n_steps + 1)
        ts = np.array([int(np.abs(lam_np[:t_start] - tv).argmin())
                       for tv in target], np.int32)
        keep = np.concatenate([[True], ts[1:] != ts[:-1]])
        ts = ts[keep]
        ts[-1] = 0
    else:
        ts = np.concatenate([np.arange(n_steps - 1, -1, -1) * interval
                             + (interval - 1), [0]]).astype(np.int32)
        ts = np.clip(ts, 0, t_start - 1)
    return ts.astype(np.int32)


def p_sample_dpmpp_2m_scan(tables: dict, denoise_fn, x, t_start: int,
                           interval: int, grid: str = "lambda", ac_np=None):
    """DPM-Solver++(2M), data-prediction form over log-SNR lambda; the first
    step is first order and the last evaluation returns x0 at t=0.
    ``ac_np``: the host copy of ``alphas_cumprod`` for the visiting ladder
    (a CUDA graph cannot capture the copy back from the device)."""
    ac = tables["alphas_cumprod"]
    ts = dpmpp_timesteps(ac.cpu().numpy() if ac_np is None else ac_np,
                         t_start, interval, grid)
    alpha = torch.sqrt(ac)
    sigma = torch.sqrt(1.0 - ac)
    lam = torch.log(alpha) - torch.log(torch.clamp(sigma, min=1e-12))
    x0_prev, h_prev = None, None
    for t_cur, t_next in zip(ts[:-1].tolist(), ts[1:].tolist()):
        tb = torch.full((x.shape[0],), t_cur, dtype=torch.long, device=x.device)
        eps = denoise_fn(x, tb)
        a_c, s_c = alpha[t_cur], torch.clamp(sigma[t_cur], min=1e-12)
        x0 = (x - s_c * eps) / torch.clamp(a_c, min=1e-12)
        h = lam[t_next] - lam[t_cur]
        if x0_prev is None:
            d = x0
        else:
            r = h / torch.clamp(torch.abs(h_prev), min=1e-12) \
                * torch.sign(h_prev + 1e-30)
            d = x0 + (x0 - x0_prev) * (0.5 * r)
        a_n, s_n = alpha[t_next], torch.clamp(sigma[t_next], min=1e-12)
        x = (s_n / s_c) * x - a_n * torch.expm1(-h) * d
        x0_prev, h_prev = x0, h
    tb0 = torch.zeros((x.shape[0],), dtype=torch.long, device=x.device)
    eps0 = denoise_fn(x, tb0)
    return (x - torch.clamp(sigma[0], min=1e-12) * eps0) \
        / torch.clamp(alpha[0], min=1e-12)


def compute_dtype(hp) -> torch.dtype:
    return torch.bfloat16 if str(hp.get("diff_compute_dtype", "")) in (
        "bf16", "bfloat16") else torch.float32


class GaussianDiffusion(nn.Module):
    """Conditioner (``fs2``) + denoiser (``denoise_fn``) + samplers.  The
    submodule names match the reference checkpoint (``model.fs2.*``,
    ``model.denoise_fn.*``)."""

    def __init__(self, hp):
        super().__init__()
        self.decoder_type = str(hp.get("diff_decoder_type", "wavenet"))
        if self.decoder_type not in ("wavenet", "fft"):
            raise ValueError(f"unknown diff_decoder_type "
                             f"{self.decoder_type!r} (wavenet or fft)")
        self.hp = hp
        self.timesteps = int(hp.get("timesteps", 1000))
        self.K_step = int(hp.get("K_step", 1000))
        self.pndm_speedup = int(hp.get("pndm_speedup", 0) or 0)
        self.tables_np = make_tables(self.timesteps,
                                     hp.get("schedule_type", "cosine"),
                                     float(hp.get("max_beta", 0.01)))
        self.fs2 = FastSpeech2(hp)
        self.denoise_fn = (FFTDecoder if self.decoder_type == "fft"
                           else diffnet.DiffNet).from_hparams(hp)
        m = int(hp["audio_num_mel_bins"])
        keep = int(hp.get("keep_bins", m))
        spec_min = np.asarray(hp.get("spec_min", [-6.0]), np.float32)
        spec_max = np.asarray(hp.get("spec_max", [1.5]), np.float32)
        if spec_min.size == 1:
            spec_min = np.full((m,), spec_min.item(), np.float32)
        if spec_max.size == 1:
            spec_max = np.full((m,), spec_max.item(), np.float32)
        self.register_buffer("spec_min", torch.from_numpy(spec_min[:keep]),
                             persistent=False)
        self.register_buffer("spec_max", torch.from_numpy(spec_max[:keep]),
                             persistent=False)
        self.mel_bins = m
        self._device_tables = {}

    def _on_device(self, key, device, make):
        """``make()``'s host arrays uploaded to ``device`` once and kept:
        sampling under a CUDA graph cannot capture an upload from pageable
        host memory."""
        key = (key, torch.device(device))
        if key not in self._device_tables:
            self._device_tables[key] = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in make().items()}
        return self._device_tables[key]

    def tables(self, device) -> dict:
        """The schedule tables (float32) on ``device``."""
        return self._on_device("schedule", device, lambda: self.tables_np)

    def ladder_tables(self, t_start: int, interval: int, sampler: str,
                      clip: bool, device) -> dict:
        """K2's per-evaluation tables on ``device``: 't_eval' [J] and
        'scal' [J, NS] for this trajectory."""
        ac = self.tables_np["alphas_cumprod"]
        if sampler in DPMPP_NAMES:
            grid = str(self.hp.get("dpmpp_grid", "lambda"))
            key = ("dpmpp", t_start, interval, grid)

            def make():
                return dict(zip(("t_eval", "scal"), _pl.dpmpp_eval_tables(
                    ac, t_start, interval, grid=grid)))
        else:
            key = ("plms", t_start, interval, bool(clip))

            def make():
                return dict(zip(("t_eval", "scal"), _pl.plms_eval_tables(
                    ac, t_start, interval, clip=bool(clip))))
        return self._on_device(key, device, make)

    def denoise_closure(self, cond: torch.Tensor):
        """denoise_fn(x f32, t) for the step-by-step samplers: the compute
        dtype denoiser over the once-projected conditioner (the FFT
        denoiser: over the conditioner), f32 out."""
        dt = compute_dtype(self.hp)
        if self.decoder_type == "fft":
            cond_c = cond.to(dt)
            return lambda x, t: self.denoise_fn(x.to(dt), t, cond_c,
                                                wdt=dt).float()
        cond_proj = diffnet.prepare_cond(self.denoise_fn, cond).to(dt)

        def fn(x, t):
            return diffnet.apply(self.denoise_fn, x.to(dt), t,
                                 cond_proj=cond_proj).float()
        return fn

    def training_loss(self, batch: dict, *, t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      train: bool = True, count=None, own=None,
                      frames: Optional[int] = None, seq: int = 1):
        """Diffusion loss of one batch (``diffsvc_tpu/models/diffusion.py:
        489-513``): returns (loss, conditioner outputs).

        ``t`` [B] and ``noise`` [B, T, M] may be passed (a test feeds the
        JAX step's draws; a data-parallel rank its rows of the global
        draws); otherwise both are drawn on the batch's device from
        ``generator`` (which lives there), t first.  With ``train`` the
        FS2-full conditioner (``no_fs2: false``) runs its dropout, drawn from
        ``generator`` after t and the noise (JAX: ``train_fs2``, only when
        ``dropout > 0``); ``train=False`` is validation's deterministic
        conditioner.  The wavenet denoiser takes the training route of
        :func:`diffnet.apply` with ``diffnet_train_stream_dtype`` and
        ``diffnet_pallas_train``; with grad enabled that is K4 or K5 and its
        backward (``diffnet.train_route``; "off" is the scan, K4 at the f32
        stream).
        ``count``, ``own`` and ``frames``: see :func:`p_losses`; a seq
        rank passes its window of every time axis with ``own`` and the
        grid's ``seq``, which takes the wavenet's scan route (K4 at the f32
        stream)."""
        dev = batch["mels"].device
        if t is None:
            t = torch.randint(0, self.K_step, (batch["mels"].shape[0],),
                              generator=generator, device=dev)
        x_start = norm_spec(batch["mels"], self.spec_min, self.spec_max)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator,
                                device=dev)
        dropout = train and not self.fs2.no_fs2 and self.fs2.dropout > 0
        ret = self.fs2(batch["hubert"], batch["mel2ph"], batch["f0"],
                       batch.get("uv"), batch.get("energy"),
                       batch.get("spk_embed"),
                       generator=generator if dropout else None)
        cond = ret["decoder_inp"]
        dt = compute_dtype(self.hp)
        stream = str(self.hp.get("diffnet_train_stream_dtype", "bf16"))
        pallas = str(self.hp.get("diffnet_pallas_train", "auto"))
        cond_c = cond.to(dt)

        def denoise_fn(x, tt):
            if self.decoder_type == "fft":
                return self.denoise_fn(x.to(dt), tt, cond_c, wdt=dt).float()
            return diffnet.apply(self.denoise_fn, x.to(dt), tt, cond_c,
                                 train_stream=stream, seq=seq,
                                 pallas_train=pallas).float()

        nonpadding = (batch["mel2ph"] > 0).to(x_start.dtype)
        loss = p_losses(self.tables(dev), denoise_fn, x_start, t.to(dev),
                        noise.to(dev, torch.float32),
                        str(self.hp.get("diff_loss_type", "l1")), nonpadding,
                        batch.get("sample_mask"), count, own, frames)
        return loss, ret

    def _ladder(self, cond, x, t_start: int, interval: int, clip_v: float,
                sampler: str):
        """Whole-trajectory sampling through K2."""
        dt = compute_dtype(self.hp)
        net = self.denoise_fn
        p = net.stacked(dt)
        cond_proj = diffnet.prepare_cond(net, cond).to(dt).contiguous()
        tabs = self.ladder_tables(t_start, interval, sampler, clip_v > 0,
                                  x.device)
        step = diffnet.step_embedding(p, tabs["t_eval"],
                                      net.residual_channels)
        sb = diffnet.step_bias(p, step, dt).transpose(0, 1).contiguous()
        return _pl.plms_ladder(
            x.float().contiguous(), tabs["scal"], sb,
            cond_proj, p["win"], p["bin"], p["wskip"], p["bskip"], p["wout"],
            p["bout"], p["wd"], p["bd"], p["wo"], p["bo"], cycle=net.cycle,
            clip_v=clip_v)

    @torch.no_grad()
    def infer(self, batch: dict, *, speedup: Optional[int] = None,
              use_gt_mel: bool = False, add_noise_step: int = 500,
              init_noise: Optional[torch.Tensor] = None,
              step_noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> dict:
        """Full sampling; returns 'mel_out' [B, T, M], 'f0_denorm', 'mel2ph'.

        ``init_noise`` ([B, T, M]) replaces the Gaussian draw — the start x
        in the default mode, the q_sample noise with ``use_gt_mel`` — so a
        caller can share noise with another implementation; otherwise the
        draw comes from ``generator``.  DDPM (``speedup <= 1``) also draws
        noise at every step: ``step_noise`` ([t_start, B, T, M], see
        :func:`p_sample_ddpm_scan`) replaces those draws."""
        ret = self.fs2(batch["hubert"], batch["mel2ph"], batch["f0"],
                       batch.get("uv"), batch.get("energy"),
                       batch.get("spk_embed"))
        cond = ret["decoder_inp"]
        b, t_mel, _ = cond.shape
        dev = cond.device
        tables = self.tables(dev)

        def noise(shape):
            if init_noise is not None:
                return init_noise.to(dev, torch.float32)
            return torch.randn(shape, generator=generator, device=dev)

        if use_gt_mel:
            t_start = int(add_noise_step)
            x0 = norm_spec(batch["mels"], self.spec_min, self.spec_max)
            tvec = torch.full((b,), t_start - 1, dtype=torch.long, device=dev)
            x = q_sample(tables, x0, tvec, noise(x0.shape))
        else:
            t_start = self.K_step
            x = noise((b, t_mel, self.mel_bins))
        speedup = self.pndm_speedup if speedup is None else int(speedup)
        sampler = str(self.hp.get("sampler", "plms")).lower()
        clip_v = float(self.hp.get("sampler_clip_x0", 0) or 0)
        if speedup and speedup > 1 and self.decoder_type == "wavenet":
            x = self._ladder(cond, x, t_start, speedup, clip_v, sampler)
        elif speedup and speedup > 1:
            # the FFT denoiser: JAX's scans, step by step
            denoise_fn = self.denoise_closure(cond)
            if clip_v > 0:
                denoise_fn = clip_x0_closure(tables, denoise_fn, clip_v)
            if sampler in DPMPP_NAMES:
                x = p_sample_dpmpp_2m_scan(
                    tables, denoise_fn, x, t_start, speedup,
                    grid=str(self.hp.get("dpmpp_grid", "lambda")),
                    ac_np=self.tables_np["alphas_cumprod"])
            else:
                x = p_sample_plms_scan(tables, denoise_fn, x, t_start,
                                       speedup)
        else:
            denoise_fn = self.denoise_closure(cond)
            if clip_v > 0:
                denoise_fn = clip_x0_closure(tables, denoise_fn, clip_v)
            x = p_sample_ddpm_scan(tables, denoise_fn, x, t_start,
                                   step_noise=None if step_noise is None
                                   else step_noise.to(dev, torch.float32),
                                   generator=generator)
        mel_out = denorm_spec(x, self.spec_min, self.spec_max)
        if batch.get("mel2ph") is not None:
            mel_out = mel_out * (batch["mel2ph"] > 0).to(mel_out.dtype)[:, :, None]
        ret["mel_out"] = mel_out
        return ret


class OfflineGaussianDiffusion(GaussianDiffusion):
    """Sampling from precomputed fs2 mels (``diffsvc_tpu/models/
    diffusion.py:588-601``, reference ``diffusion.py:299-332``; no task of
    the repository uses it): with ``batch['fs2_mels']`` and
    ``gaussian_start: false`` the start is that mel q-sampled to K_step-1
    (``use_gt_mel`` at ``add_noise_step = K_step``); otherwise the parent's
    sampling from Gaussian noise."""

    def infer(self, batch: dict, *, speedup: Optional[int] = None,
              **kwargs) -> dict:
        fs2_mels = batch.get("fs2_mels")
        if fs2_mels is None or self.hp.get("gaussian_start", True):
            return super().infer(batch, speedup=speedup, **kwargs)
        kwargs.pop("use_gt_mel", None)
        kwargs.pop("add_noise_step", None)
        return super().infer(dict(batch, mels=fs2_mels), speedup=speedup,
                             use_gt_mel=True, add_noise_step=self.K_step,
                             **kwargs)
