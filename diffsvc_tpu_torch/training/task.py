"""SVC training task: model, optimizer and the train / validation steps.

Counterpart of ``diffsvc_tpu/training/task.py`` (reference
``training/task/SVC_task.py``): GaussianDiffusion with the wavenet decoder,
AdamW (betas ``optimizer_adam_beta1/2``, ``weight_decay``, eps 1e-8) or,
with ``optimizer: radam``, ``optax.radam``'s update (:class:`RAdam`, no
weight decay) behind clip-by-global-norm, StepLR or RSQRT by optimizer
step, gradient accumulation with ``optax.MultiSteps`` semantics, an
optional EMA of the weights, and the diffusion loss as the 'mel' loss.

One step runs eagerly: the loss through K4 or K5 (``diffnet.apply``'s
training route, picked by the batch's shape), ``torch.autograd.grad``, then
the update.  It runs on the card unless ``device="cpu"`` is asked for.  The step's random draws
(t and the noise) come from a ``torch.Generator`` on the task's device
seeded from (``seed``, step), so a step's draws do not depend on the steps
before it, as JAX folds the step into its key.  Single device; DDP is later
work.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Optional

import numpy as np
import torch

from ..infer.svc import default_device
from ..models.diffusion import GaussianDiffusion
from ..utils.convert import strip_prefix
from .scheduler import build_lr_schedule

BATCH_KEYS = ("hubert", "mels", "mel2ph", "energy", "f0", "uv", "sample_mask")


TRAIN, VALID, SAMPLE = 0, 1, 2   # streams of draws


def draw_generator(device, seed: int, *key: int) -> torch.Generator:
    """Generator on ``device`` seeded from (seed, *key): (TRAIN, step) for a
    train step's draws, (VALID,) for validation, (SAMPLE,) for sampling."""
    s = np.random.SeedSequence([int(seed), *map(int, key)]).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(s[0]))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient (optax.global_norm)."""
    return torch.sqrt(sum(g.float().pow(2).sum() for g in grads))


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm: unchanged below ``max_norm``, else each
    ``g / norm * max_norm`` (no epsilon, unlike ``clip_grad_norm_``)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


class RAdam(torch.optim.Optimizer):
    """``optax.radam(lr, b1, b2, eps=1e-8)``'s update (the JAX task's
    ``optimizer: radam``), which ``torch.optim.RAdam`` is not: torch adds
    eps to sqrt(v) before the bias correction and rectifies only when
    rho_t > 5.  Here, per step t (from 1):

        m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        m_hat = m / (1 - b1^t);  v_hat = v / (1 - b2^t)
        rho_t = rho_inf - 2 t b2^t / (1 - b2^t),  rho_inf = 2 / (1 - b2) - 1
        u = r_t m_hat / (sqrt(v_hat) + eps)   if rho_t >= 5 (optax's >=)
        u = m_hat                             otherwise
        p -= lr u

    with r_t from :func:`rectification`.  No weight decay."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, threshold: float = 5.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      threshold=threshold))

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter with a grad, each group's tensors
        at once (``torch._foreach_*``: a handful of launches per group, not
        per tensor); r_t and the bias corrections are per-step scalars."""
        for group in self.param_groups:
            b1, b2 = group["betas"]
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
            t = int(states[0]["step"])
            grads = [p.grad for p in params]
            m = [st["exp_avg"] for st in states]
            v = [st["exp_avg_sq"] for st in states]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1.0 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
            lr_t = group["lr"] / (1.0 - b1 ** t)
            r = rectification(t, b2, group["threshold"])
            if r is None:
                torch._foreach_add_(params, m, alpha=-lr_t)
                continue
            den = torch._foreach_div(v, 1.0 - b2 ** t)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_addcdiv_(params, m, den, value=-lr_t * r)


def rectification(t: int, b2: float, threshold: float = 5.0):
    """RAdam's variance rectification r_t at step ``t`` (from 1), or None
    where rho_t < ``threshold`` (the update is then the bias-corrected
    momentum alone).  With b2 = 0.98, rho_t first reaches 5 at step 6."""
    rho_inf = 2.0 / (1.0 - b2) - 1.0
    b2t = b2 ** t
    rho = rho_inf - 2.0 * t * b2t / (1.0 - b2t)
    if rho < threshold:
        return None
    return math.sqrt((rho - 4.0) * (rho - 2.0) * rho_inf
                     / ((rho_inf - 4.0) * (rho_inf - 2.0) * rho))


class Optimized:
    """The optimization shared by the tasks, as the JAX tasks' optax chain:
    ``clip_by_global_norm`` then AdamW (``weight_decay``) or RAdam (none),
    behind ``optax.MultiSteps`` accumulation of
    ``accumulate_grad_batches`` micro-steps, the lr taken at the optimizer
    step.  A task sets ``hp``, ``params`` and ``optimizer_name`` and calls
    :meth:`init_optimizer`."""

    def init_optimizer(self) -> None:
        hp = self.hp
        self.lr_schedule = build_lr_schedule(hp)
        self.accumulate = int(hp.get("accumulate_grad_batches", 1) or 1)
        self.max_norm = float(hp.get("clip_grad_norm", 1) or 1e9)
        betas = (float(hp.get("optimizer_adam_beta1", 0.9)),
                 float(hp.get("optimizer_adam_beta2", 0.98)))
        if self.optimizer_name == "radam":
            self.optimizer = RAdam(self.params, lr=self.lr_schedule(0),
                                   betas=betas, eps=1e-8)
        else:
            self.optimizer = torch.optim.AdamW(
                self.params, lr=self.lr_schedule(0), betas=betas, eps=1e-8,
                weight_decay=float(hp.get("weight_decay", 0) or 0.0))
        self.step = 0          # micro-steps (the trainer's global_step)
        self.opt_steps = 0     # optimizer updates made
        self.mini_step = 0     # position inside an accumulation window
        self.acc = None        # running mean of the window's grads

    def apply_grads(self, grads) -> float:
        """One micro-step's grads (one per parameter): accumulated, and at
        the end of each window clipped and applied.  Returns the lr metric
        (the schedule at ``step // accumulate``)."""
        lr = self.lr_schedule(self.step // self.accumulate)
        if self.acc is None:
            self.acc = grads
        else:   # optax.MultiSteps' running mean
            self.acc = [a + (g - a) / (self.mini_step + 1)
                        for a, g in zip(self.acc, grads)]
        if self.mini_step == self.accumulate - 1:
            for p, g in zip(self.params,
                            clip_by_global_norm(self.acc, self.max_norm)):
                p.grad = g
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr_schedule(self.opt_steps)
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.opt_steps += 1
            self.acc = None
        self.mini_step = (self.mini_step + 1) % self.accumulate
        self.step += 1
        return lr

    def optimizer_state(self) -> Dict:
        """The checkpoint's ``optimizer_states`` and ``accumulation``."""
        return {"optimizer_states": [self.optimizer.state_dict()],
                "accumulation": {
                    "opt_steps": self.opt_steps, "mini_step": self.mini_step,
                    "acc_grads": None if self.acc is None else
                    [g.detach().cpu().clone() for g in self.acc]}}

    def load_optimizer_state(self, ckpt: Dict) -> None:
        # a copy: load_state_dict keeps the given state tensors where their
        # device and dtype already fit, and the steps update them in place
        self.optimizer.load_state_dict(
            copy.deepcopy(ckpt["optimizer_states"][0]))
        acc = ckpt.get("accumulation") or {}
        self.opt_steps = int(acc.get("opt_steps", 0))
        self.mini_step = int(acc.get("mini_step", 0))
        grads = acc.get("acc_grads")
        self.acc = None if grads is None else [g.to(self.device)
                                               for g in grads]
        self.step = int(ckpt["global_step"])


def optimizer_name(hp) -> str:
    name = str(hp.get("optimizer", "adamw")).lower()
    if name not in ("adamw", "adam", "radam"):
        raise ValueError(f"unknown optimizer: {name!r}")
    return name


class SVCTask(Optimized):
    def __init__(self, hp, device=None):
        self.hp = hp
        self.device = default_device(device)
        self.ema_decay = float(hp.get("ema_decay", 0) or 0)
        self.seed = int(hp.get("seed", 1234))
        self.optimizer_name = optimizer_name(hp)
        self.model = GaussianDiffusion(hp).to(self.device)
        self.init_state()

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> None:
        """Fresh weights drawn from ``seed`` (default ``hp['seed']``; the
        JAX package's init: zero output head), a fresh optimizer, step 0."""
        seed = self.seed if seed is None else int(seed)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            fresh = GaussianDiffusion(self.hp)
        self.model.load_state_dict(fresh.state_dict())
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        self.init_optimizer()
        self.ema = None
        if self.ema_decay > 0:
            self.ema = copy.deepcopy(self.model).requires_grad_(False)

    def load_params(self, sd: Dict[str, torch.Tensor]) -> None:
        """Warm start from a model state dict; the EMA restarts from it."""
        self.model.load_state_dict(sd)
        if self.ema is not None:
            self.ema.load_state_dict(sd)

    # ------------------------------------------------------------------
    def prepare_batch(self, batch: Dict) -> Dict:
        """The model's inputs of a collated numpy batch, on the device."""
        jb = {k: torch.as_tensor(batch[k]).to(self.device) for k in BATCH_KEYS
              if batch.get(k) is not None}
        if self.hp.get("use_spk_id") and "spk_ids" in batch:
            jb["spk_embed"] = torch.as_tensor(batch["spk_ids"]).to(self.device)
        return jb

    def train_step(self, batch: Dict, *, t=None, noise=None) -> Dict:
        """One micro-step: loss, grads, and an optimizer update at the end
        of each accumulation window.  ``t`` and ``noise`` override the
        step's draws.  Returns metrics loss, mel, lr, grad_norm (tensors
        stay on the device; read them only when logging)."""
        jb = self.prepare_batch(batch)
        loss, _ = self.model.training_loss(
            jb, t=t, noise=noise,
            generator=draw_generator(self.device, self.seed, TRAIN,
                                     self.step))
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        loss = loss.detach()
        # a parameter the loss does not reach gets a zero grad, as in JAX
        # (AdamW then still applies its weight decay to it)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        grad_norm = global_norm(grads)
        if self.hp.get("print_nan_grads"):
            for name, g in zip(self.names, grads):
                if not bool(torch.isfinite(g).all()):
                    print(f"| WARNING: non-finite grad in {name} at step "
                          f"{self.step} (loss={float(loss)})")
        lr = self.apply_grads(grads)
        if self.ema is not None:
            d = self.ema_decay
            with torch.no_grad():
                for e, p in zip(self.ema.parameters(), self.params):
                    e.copy_(d * e + (1.0 - d) * p)
        return {"loss": loss, "mel": loss, "lr": lr, "grad_norm": grad_norm}

    @torch.no_grad()
    def val_step(self, batch: Dict) -> float:
        """Validation loss: the no-grad route (K1), the same draws for every
        call (JAX uses one fixed key)."""
        loss, _ = self.model.training_loss(
            self.prepare_batch(batch),
            generator=draw_generator(self.device, self.seed, VALID))
        return float(loss)

    @torch.no_grad()
    def sample(self, batch: Dict, speedup: Optional[int] = None,
               init_noise=None, key=()) -> Dict:
        """Full sampling through K2 with the EMA weights when kept.  The
        draws come from the (SAMPLE, *key) stream (the test runner passes
        the item's index, as JAX folds it into its key); ``init_noise``
        ([B, T, M]) replaces the start draw."""
        model = self.ema if self.ema is not None else self.model
        return model.infer(self.prepare_batch(batch),
                           speedup=speedup or self.hp.get("pndm_speedup", 10)
                           or 10, init_noise=init_noise,
                           generator=draw_generator(self.device, self.seed,
                                                    SAMPLE, *key))

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        """The checkpoint's contents (see training/checkpoint.py)."""
        def cpu(sd):
            return {k: v.detach().cpu().clone() for k, v in sd.items()}

        out = {"state_dict": {f"model.{k}": v for k, v in
                              cpu(self.model.state_dict()).items()},
               **self.optimizer_state()}
        if self.ema is not None:
            out["ema_state_dict"] = cpu(self.ema.state_dict())
        return out

    def load_state_dict(self, ckpt: Dict) -> None:
        """Resume from a checkpoint written from :meth:`state_dict`."""
        self.model.load_state_dict(strip_prefix(ckpt["state_dict"], "model."))
        self.load_optimizer_state(ckpt)
        if self.ema is not None:
            self.ema.load_state_dict(ckpt.get("ema_state_dict")
                                     or self.model.state_dict())
