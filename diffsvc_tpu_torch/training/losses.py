"""FastSpeech2-family losses (reference training/task/fs2.py:34-266).

Counterpart of ``diffsvc_tpu/training/losses.py``:

- ``mel_losses``: parses the ``mel_loss: "ssim:0.5|l1:0.5"`` spec and
  computes masked L1 / SSIM (bias +6, nonzero-speech weights) / MSE terms,
- duration loss (MSE in log domain, +1 offset),
- pitch (f0 L2/L1 + uv BCE) via pe_task.f0_uv_losses,
- energy loss (MSE, nonpadding masked).

Every denominator is clamped to >= 1, so an all-padding batch gives 0.
The SVC task's loss is the diffusion noise loss; these serve the pe task
(``f0_uv_losses``) and the FastSpeech2 heads.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.ssim import ssim
from .pe_task import f0_uv_losses  # noqa: F401  (re-exported, as in JAX)


def _masked_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x * w).sum() / torch.clamp(w.sum(), min=1)


def weights_nonzero_speech(target: torch.Tensor) -> torch.Tensor:
    """[B, T, M] -> [B, T, M] mask of the rows whose mel frame is nonzero."""
    dim = target.shape[-1]
    return (target.abs().sum(-1, keepdim=True) > 0).to(target.dtype) \
        .repeat_interleave(dim, dim=-1)


def l1_loss(decoder_output, target):
    return _masked_mean((decoder_output - target).abs(),
                        weights_nonzero_speech(target))


def mse_loss(decoder_output, target):
    return _masked_mean((decoder_output - target) ** 2,
                        weights_nonzero_speech(target))


def ssim_loss(decoder_output, target, bias: float = 6.0):
    s = 1.0 - ssim(decoder_output + bias, target + bias, size_average=False)
    return _masked_mean(s, weights_nonzero_speech(target))


def mel_losses(decoder_output, target, mel_loss_spec: str = "ssim:0.5|l1:0.5"
               ) -> Dict[str, torch.Tensor]:
    """Parse 'name:weight|name:weight' and compute each weighted term."""
    out = {}
    for term in mel_loss_spec.split("|"):
        name, _, w = term.partition(":")
        weight = float(w) if w else 1.0
        if name == "l1":
            out["l1"] = l1_loss(decoder_output, target) * weight
        elif name in ("mse", "l2"):
            out["mse"] = mse_loss(decoder_output, target) * weight
        elif name == "ssim":
            out["ssim"] = ssim_loss(decoder_output, target) * weight
        else:
            raise ValueError(f"unknown mel loss {name}")
    return out


def mel2ph_to_dur(mel2ph: torch.Tensor, t_txt: int) -> torch.Tensor:
    """[B, T_mel] 1-based phone ids (0 = padding) -> [B, t_txt] frame
    counts per phone; ids above ``t_txt`` are dropped, as JAX's scatter
    drops out-of-bounds updates."""
    mel2ph = mel2ph.long()
    keep = (mel2ph <= t_txt).long()
    dur = torch.zeros(mel2ph.shape[0], t_txt + 1, dtype=torch.long,
                      device=mel2ph.device)
    dur.scatter_add_(1, mel2ph.clamp(max=t_txt), keep)
    return dur[:, 1:]


def dur_loss(dur_pred_log, mel2ph, txt_lengths, nonpadding):
    """MSE between predicted log-duration and log(dur+1) (fs2 'mse' mode)."""
    dur_gt = mel2ph_to_dur(mel2ph, int(txt_lengths)).float()
    return _masked_mean((dur_pred_log - torch.log(dur_gt + 1)) ** 2,
                        nonpadding)


def energy_loss(energy_pred, energy_gt, nonpadding):
    return _masked_mean((energy_pred - energy_gt) ** 2, nonpadding)
