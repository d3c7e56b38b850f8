"""PitchExtractionTask: trains the mel -> f0 PitchExtractor ("pe") that the
24 kHz profile's ``pe_ckpt`` points at.

Counterpart of ``diffsvc_tpu/training/pe_task.py`` (reference
``training/pe.py``): the f0 L2 (or L1) and uv BCE losses over the mel's
nonpadding frames, AdamW behind clip-by-global-norm with ``optax.MultiSteps``
accumulation, ``pitch_extractor_conv_layers`` (default 2) residual blocks.
As in the JAX task, the prenet's BatchNorm runs in its eval form and its
running statistics are trained as parameters (JAX keeps them in the
params tree).  The interface is ``SVCTask``'s (``train_step``,
``val_step``, ``sample``, ``state_dict``, ``load_state_dict``), so the
``Trainer`` runs it; a checkpoint it writes is one that ``Svc`` loads as
``pe_ckpt``.  It runs on the card unless ``device="cpu"`` is asked for;
pe's convolutions, forward and backward, are true f32
(``models.nn.true_f32_convs``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..infer.svc import default_device
from ..models import nn as fnn
from ..models.pe import PitchExtractor
from ..utils.convert import strip_prefix
from .task import Optimized, global_norm

PE_KEYS = ("mels", "f0", "uv", "pitch", "sample_mask")


def f0_uv_losses(pitch_pred, f0, uv, nonpadding, *, lambda_f0=1.0,
                 lambda_uv=1.0, use_uv=True, pitch_loss="l2"):
    """f0 regression + uv classification losses (reference fs2 add_f0_loss
    semantics: uv BCE with logits over nonpadding; the f0 loss over voiced
    nonpadding; denominators clamped to >= 1)."""
    losses = {}
    if use_uv:
        bce = F.binary_cross_entropy_with_logits(pitch_pred[:, :, 1], uv,
                                                 reduction="none")
        losses["uv"] = (bce * nonpadding).sum() \
            / torch.clamp(nonpadding.sum(), min=1) * lambda_uv
        nonpadding = nonpadding * (uv == 0).to(nonpadding.dtype)
    diff = pitch_pred[:, :, 0] - f0
    err = diff.abs() if pitch_loss == "l1" else diff ** 2
    losses["f0"] = (err * nonpadding).sum() \
        / torch.clamp(nonpadding.sum(), min=1) * lambda_f0
    return losses


def _train_bn_stats(model: PitchExtractor) -> None:
    """The prenet BatchNorms' running mean and var as parameters (same
    state-dict names), as the JAX task trains them."""
    for layer in model.mel_prenet.layers:
        bn = layer[2]
        for name in ("running_mean", "running_var"):
            bn.register_parameter(name, nn.Parameter(bn._buffers.pop(name)))


class PitchExtractionTask(Optimized):
    def __init__(self, hp, device=None):
        self.hp = hp
        self.device = default_device(device)
        self.seed = int(hp.get("seed", 1234))
        self.conv_layers = int(hp.get("pitch_extractor_conv_layers", 2))
        self.optimizer_name = "adamw"     # the JAX pe task's, whatever hp says
        self.ema = None
        self.model = PitchExtractor(hp, conv_layers=self.conv_layers)
        _train_bn_stats(self.model)
        self.model.to(self.device).eval()
        self.init_state()

    def init_state(self, seed: Optional[int] = None) -> None:
        """Fresh weights drawn from ``seed`` (PyTorch's default init, the
        JAX package's ``pe.init``: BatchNorm mean 0 / var 1), a fresh
        optimizer, step 0."""
        seed = self.seed if seed is None else int(seed)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            fresh = PitchExtractor(self.hp, conv_layers=self.conv_layers)
        self.model.load_state_dict(fresh.state_dict())
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        self.init_optimizer()

    def load_params(self, sd: Dict[str, torch.Tensor]) -> None:
        self.model.load_state_dict(sd)

    # ------------------------------------------------------------------
    def prepare_batch(self, batch: Dict) -> Dict:
        return {k: torch.as_tensor(batch[k]).to(self.device) for k in PE_KEYS
                if batch.get(k) is not None}

    def loss(self, batch: Dict):
        """(total loss, {'uv', 'f0'}) of a collated numpy batch."""
        jb = self.prepare_batch(batch)
        mels = jb["mels"].float()
        out = self.model.compute(mels)
        nonpadding = (mels.abs().sum(-1) > 0).float()
        if "sample_mask" in jb:
            nonpadding = nonpadding * jb["sample_mask"].float()[:, None]
        hp = self.hp
        losses = f0_uv_losses(
            out["pitch_pred"], jb["f0"].float(), jb["uv"].float(), nonpadding,
            lambda_f0=float(hp.get("lambda_f0", 1.0)),
            lambda_uv=float(hp.get("lambda_uv", 1.0)),
            use_uv=hp.get("pitch_type", "frame") == "frame",
            pitch_loss=hp.get("pitch_loss", "l2"))
        return sum(losses.values()), losses

    def loss_and_grads(self, batch: Dict):
        """(loss, {'uv', 'f0'}, one grad per parameter) of a batch.  The
        backward's convolutions run in true f32 too: cuDNN reads
        ``allow_tf32`` when the backward runs, not when the forward
        recorded it."""
        with fnn.true_f32_convs():
            loss, losses = self.loss(batch)
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        return loss.detach(), {k: v.detach() for k, v in losses.items()}, \
            grads

    def train_step(self, batch: Dict) -> Dict:
        """One micro-step: loss, grads, and an AdamW update at the end of
        each accumulation window.  Metrics loss, uv, f0, lr, grad_norm."""
        loss, losses, grads = self.loss_and_grads(batch)
        grad_norm = global_norm(grads)
        lr = self.apply_grads(grads)
        return {"loss": loss, **losses, "lr": lr, "grad_norm": grad_norm}

    @torch.no_grad()
    def val_step(self, batch: Dict) -> float:
        return float(self.loss(batch)[0])

    @torch.no_grad()
    def sample(self, batch: Dict, speedup: Optional[int] = None,
               init_noise=None, key=()) -> Dict:
        """pe's prediction; ``mel_out`` is the input mels and ``f0_denorm``
        pe's f0, for the trainer's generic plots and the test runner (as
        JAX's).  pe draws nothing: the sampling arguments are unused."""
        mels = self.prepare_batch(batch)["mels"].float()
        out = self.model(mels)
        out["mel_out"] = mels
        out["f0_denorm"] = out["f0_denorm_pred"]
        return out

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        """The checkpoint's contents: the reference pe layout
        (``model.mel_prenet...``) that ``models.pe.load`` reads."""
        return {"state_dict": {f"model.{k}": v.detach().cpu().clone()
                               for k, v in self.model.state_dict().items()},
                **self.optimizer_state()}

    def load_state_dict(self, ckpt: Dict) -> None:
        self.model.load_state_dict(strip_prefix(ckpt["state_dict"], "model."))
        self.load_optimizer_state(ckpt)
