"""diff-svc's training step, plainly: the l2 denoising loss of a batch
(``diffusion.py``'s ``p_losses`` with the no_fs2 conditioner), its
gradients by autograd, clip by global norm and torch's AdamW, in f32 (TF32
off unless a control turns it on).  The batch's rows are taken in blocks
so that the backward fits; the blocks' gradients add up to the batch's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import nets

def loss_and_grads(params: dict, hp: dict, batch: dict, t, noise,
                   device, rows_per_block: int = 8, rows=None):
    """(loss, {name: grad}) of a collated numpy ``batch`` with the step's
    t [B] and noise [B, T, M]; ``rows`` (a slice) keeps only those rows, the
    mean taken over them (a fault of the control's)."""
    n = int(np.shape(batch["mels"])[0])
    rows = rows or slice(0, n)
    mask = np.asarray(batch.get("sample_mask", np.ones(n, np.float32)),
                      np.float32)
    keep = np.zeros(n, np.float32)
    keep[rows] = mask[rows]
    count = max(float(keep.sum()), 1.0)
    ac = torch.from_numpy(nets.alphas_cumprod(hp)).to(device)
    lo = float(np.asarray(hp["spec_min"]).ravel()[0])
    hi = float(np.asarray(hp["spec_max"]).ravel()[0])
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total = 0.0
    for a in range(rows.start, rows.stop, rows_per_block):
        b = min(a + rows_per_block, rows.stop)
        blk = {k: torch.as_tensor(np.asarray(batch[k])[a:b]).to(device)
               for k in ("hubert", "mels", "mel2ph", "f0")}
        tt = t[a:b].to(device)
        nz = noise[a:b].to(device, torch.float32)
        x0 = (blk["mels"] - lo) / (hi - lo) * 2.0 - 1.0
        a_t = ac[tt][:, None, None]
        xt = torch.sqrt(a_t) * x0 + torch.sqrt(1.0 - a_t) * nz
        cond, _ = nets.condition(leaves, hp, blk["hubert"], blk["mel2ph"],
                                 blk["f0"])
        eps = nets.diffnet(leaves, hp, xt, tt,
                           nets.cond_projections(leaves, hp, cond))
        per_row = ((nz - eps) ** 2).mean(dim=(1, 2))
        w = torch.as_tensor(keep[a:b]).to(device)
        loss = (per_row * w).sum() / count
        loss.backward()
        total += float(loss.detach())
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return total, grads


def clip(grads: dict, max_norm: float) -> dict:
    norm = math.sqrt(sum(float((g.double() ** 2).sum())
                         for g in grads.values()))
    if norm < max_norm:
        return grads
    return {k: g / norm * max_norm for k, g in grads.items()}


class AdamW:
    """torch.optim.AdamW's update (decoupled weight decay, bias-corrected
    moments, eps outside the root)."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.lr, self.b1, self.b2 = lr, betas[0], betas[1]
        self.eps, self.wd = eps, weight_decay
        self.m, self.v, self.t = {}, {}, 0

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            m = self.m.get(k, torch.zeros_like(p)) * self.b1 \
                + (1 - self.b1) * g
            v = self.v.get(k, torch.zeros_like(p)) * self.b2 \
                + (1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            p = p * (1 - self.lr * self.wd)
            out[k] = p - (self.lr / c1) * m / (torch.sqrt(v) / math.sqrt(c2)
                                               + self.eps)
        return out


def run_steps(params: dict, hp: dict, steps: list, device,
              rows=None, keep=None) -> dict:
    """Follow the program's first steps: ``steps`` is [(batch, t, noise)];
    returns every step's loss, the first step's clipped gradient (as the
    optimizer gets it) and the parameters after the first ``keep`` steps
    (all of them by default)."""
    opt = AdamW(float(hp["lr"]), (float(hp["optimizer_adam_beta1"]),
                                  float(hp["optimizer_adam_beta2"])),
                1e-8, float(hp.get("weight_decay", 0) or 0.0))
    losses, first = [], None
    p = {k: v.detach().clone() for k, v in params.items()}
    for batch, t, noise in steps:
        loss, grads = loss_and_grads(p, hp, batch, t, noise, device,
                                     rows=rows)
        grads = clip(grads, float(hp.get("clip_grad_norm", 1) or 1e9))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(loss)
        with torch.no_grad():
            p = opt.step(p, grads)
        if len(losses) == keep:
            kept = p
    return {"losses": losses, "grad1": first,
            "params": p if keep is None else kept}
