"""Shared small utilities (reference utils/__init__.py:28-250): loss meters,
parameter counting, checkpoint globbing.

Counterpart of ``diffsvc_tpu/utils/misc.py``: ``num_params`` counts an
``nn.Module``'s parameters or a state dict's tensors, and
``get_last_checkpoint`` is the port's ``training.checkpoint``.  The
timers are the port's spans (``utils/trace.py``); JAX's
``start_profiler_server`` has no PyTorch counterpart and is not ported.
"""

from __future__ import annotations

from typing import Optional


class AvgrageMeter:
    """(sic — reference name kept) running average of a scalar."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.avg = 0.0
        self.sum = 0.0
        self.cnt = 0

    def update(self, val, n: int = 1):
        self.sum += val * n
        self.cnt += n
        self.avg = self.sum / self.cnt


def num_params(params, print_out: bool = True, model_name: str = "model") -> float:
    """Parameter count in millions of an ``nn.Module`` (its parameters) or
    a state dict (every tensor in it)."""
    import torch

    if isinstance(params, torch.nn.Module):
        tensors = list(params.parameters())
    else:
        tensors = [v for v in params.values() if hasattr(v, "shape")]
    m = sum(int(t.numel()) for t in tensors) / 1_000_000
    if print_out:
        print(f"| {model_name} Trainable Parameters: {m:.3f}M")
    return m


def get_last_checkpoint(work_dir: str) -> Optional[str]:
    """Alias for training.checkpoint.latest_checkpoint (single source of
    truth for the model_ckpt_steps_*.ckpt naming/rotation scheme)."""
    from ..training.checkpoint import latest_checkpoint

    return latest_checkpoint(work_dir)
