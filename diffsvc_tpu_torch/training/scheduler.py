"""LR schedules of the reference trainer, as functions of the OPTIMIZER step.

Counterpart of ``diffsvc_tpu/training/scheduler.py``: the schedule is read
once per optimizer update, with the number of updates made so far (optax's
count inside ``MultiSteps``), which is the reference's
``global_step // accumulate_grad_batches`` (``SVC_task.py:125``).

- StepLR halving every ``decay_steps`` (SVCTask: torch StepLR(gamma=0.5)).
- RSQRT with warmup (reference ``utils/training_utils.py:16-23``).
"""

from __future__ import annotations


def rsqrt_schedule(lr: float, warmup_updates: int, hidden_size: int):
    """lr * min(step/warmup, 1) * max(warmup, step)^-0.5 * hidden^-0.5,
    floored at 1e-7."""

    def schedule(step: int) -> float:
        s = float(step)
        warmup = min(s / warmup_updates, 1.0)
        rsqrt_decay = max(float(warmup_updates), s) ** -0.5
        return max(lr * warmup * rsqrt_decay * hidden_size ** -0.5, 1e-7)

    return schedule


def step_lr_schedule(lr: float, decay_steps: int, gamma: float = 0.5):
    """StepLR: ``lr * gamma ** (step // decay_steps)``."""

    def schedule(step: int) -> float:
        return lr * gamma ** (int(step) // decay_steps)

    return schedule


def build_lr_schedule(hp):
    if hp.get("scheduler", "step_lr") == "rsqrt":
        return rsqrt_schedule(hp["lr"], hp.get("warmup_updates", 2000),
                              hp["hidden_size"])
    return step_lr_schedule(hp["lr"], hp.get("decay_steps", 40000), 0.5)
