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

Data parallel as ``SVCTask``: each rank takes its contiguous rows of the
global batch and divides by the global batch's frame counts, and the
gradients and losses are summed over ranks.  Under a seq axis the step is
replicated over seq, as JAX shards it on ``data`` alone
(``pe_task.py:100-106``): the rank at seq index 0 of each data block
computes the block's share and the other seq ranks add zeros to the same
SUM ``all_reduce``, so no block counts s times and every rank ends with
the same numbers.  pe's BatchNorm runs on its running statistics in
training too (``diffsvc_tpu/models/pe.py:51-52, 104``), so no statistic
crosses samples and no synced BatchNorm is needed.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..infer.svc import default_device
from ..models import nn as fnn
from ..models.pe import PitchExtractor
from ..parallel import dist
from ..utils.convert import strip_prefix
from .task import Optimized, global_norm, local_rows

PE_KEYS = ("mels", "f0", "uv", "pitch", "sample_mask")


def f0_uv_losses(pitch_pred, f0, uv, nonpadding, *, lambda_f0=1.0,
                 lambda_uv=1.0, use_uv=True, pitch_loss="l2", counts=None):
    """f0 regression + uv classification losses (reference fs2 add_f0_loss
    semantics: uv BCE with logits over nonpadding; the f0 loss over voiced
    nonpadding; denominators clamped to >= 1).  ``counts`` (the uv and the
    f0 denominators) replaces the two frame counts: a data-parallel rank
    passes the global batch's (:func:`frame_counts`)."""
    def count(mask, i):
        return torch.clamp(mask.sum(), min=1) if counts is None else counts[i]

    losses = {}
    if use_uv:
        bce = F.binary_cross_entropy_with_logits(pitch_pred[:, :, 1], uv,
                                                 reduction="none")
        losses["uv"] = (bce * nonpadding).sum() / count(nonpadding, 0) \
            * lambda_uv
        nonpadding = nonpadding * (uv == 0).to(nonpadding.dtype)
    diff = pitch_pred[:, :, 0] - f0
    err = diff.abs() if pitch_loss == "l1" else diff ** 2
    losses["f0"] = (err * nonpadding).sum() / count(nonpadding, 1) \
        * lambda_f0
    return losses


def frame_counts(batch: Dict, use_uv: bool = True):
    """The uv and f0 denominators of :func:`f0_uv_losses` over a whole
    collated batch (host numpy): its nonpadding frames (a mel row not all
    zero, in a real row of ``sample_mask``) and, with ``use_uv``, the
    voiced ones among them; each at least 1."""
    mels = np.asarray(batch["mels"], np.float32)
    nonpadding = np.abs(mels).sum(-1) > 0
    if batch.get("sample_mask") is not None:
        nonpadding &= np.asarray(batch["sample_mask"])[:, None] > 0
    n_all = max(float(nonpadding.sum()), 1.0)
    if not use_uv:
        return n_all, n_all
    voiced = nonpadding & (np.asarray(batch["uv"]) == 0)
    return n_all, max(float(voiced.sum()), 1.0)


def _train_bn_stats(model: PitchExtractor) -> None:
    """The prenet BatchNorms' running mean and var as parameters (same
    state-dict names), as the JAX task trains them."""
    for layer in model.mel_prenet.layers:
        bn = layer[2]
        for name in ("running_mean", "running_var"):
            bn.register_parameter(name, nn.Parameter(bn._buffers.pop(name)))


class PitchExtractionTask(Optimized):
    def __init__(self, hp, device=None, grid: Optional[dist.Grid] = None):
        self.hp = hp
        self.device = default_device(device)
        self.grid = dist.grid(hp) if grid is None else grid
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

    def use_uv(self) -> bool:
        return self.hp.get("pitch_type", "frame") == "frame"

    def loss(self, batch: Dict, counts=None):
        """(total loss, {'uv', 'f0'}) of a collated numpy batch; ``counts``:
        see :func:`f0_uv_losses`."""
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
            use_uv=self.use_uv(), pitch_loss=hp.get("pitch_loss", "l2"),
            counts=counts)
        return sum(losses.values()), losses

    def loss_and_grads(self, batch: Dict):
        """(loss, {'uv', 'f0'}, one grad per parameter) of this rank's rows
        of a global batch, normalized by the global batch's frame counts,
        not yet summed over ranks (zeros past seq index 0).  The backward's
        convolutions run in true f32 too: cuDNN reads ``allow_tf32`` when
        the backward runs, not when the forward recorded it."""
        i, j = self.grid.cell(dist.rank())
        if j:
            zero = torch.zeros((), device=self.device)
            keys = ("uv", "f0") if self.use_uv() else ("f0",)
            return zero, dict.fromkeys(keys, zero), \
                [torch.zeros_like(p) for p in self.params]
        counts = frame_counts(batch, self.use_uv())
        local = local_rows(batch, dist.block(int(np.shape(batch["mels"])[0]),
                                             i, self.grid.data))
        with fnn.true_f32_convs():
            loss, losses = self.loss(local, counts)
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        return loss.detach(), {k: v.detach() for k, v in losses.items()}, \
            grads

    def train_step(self, batch: Dict) -> Dict:
        """One micro-step on a global batch: this rank's loss and grads,
        their SUM over ranks, and an AdamW update at the end of each
        accumulation window.  Metrics loss, uv, f0, lr, grad_norm."""
        loss, losses, grads = self.loss_and_grads(batch)
        n = len(grads)
        summed = dist.all_reduce_sum([*grads, loss, *losses.values()])
        grads, loss = summed[:n], summed[n]
        losses = dict(zip(losses, summed[n + 1:]))
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
