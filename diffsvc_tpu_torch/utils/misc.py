"""Shared small utilities (reference utils/__init__.py:28-250): loss meters,
timers with named profiler spans, parameter counting, checkpoint globbing.

Counterpart of ``diffsvc_tpu/utils/misc.py``: ``Timer``'s span is a
``torch.profiler.record_function`` range, ``num_params`` counts an
``nn.Module``'s parameters or a state dict's tensors, and
``get_last_checkpoint`` is the port's ``training.checkpoint``.  JAX's
``start_profiler_server`` has no PyTorch counterpart and is not ported.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, Optional


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


class Timer:
    """Context-manager timer with a global accumulation map and, with
    ``trace``, a ``torch.profiler.record_function`` span of the same name
    (visible in a ``torch.profiler`` trace)."""

    timer_map: Dict[str, float] = defaultdict(float)

    def __init__(self, name: str, print_time: bool = False, trace: bool = True):
        self.name = name
        self.print_time = print_time
        self.trace = trace
        self._span = None

    def __enter__(self):
        if self.trace:
            import torch

            self._span = torch.profiler.record_function(self.name)
            self._span.__enter__()
        self.t = time.time()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        dt = time.time() - self.t
        Timer.timer_map[self.name] += dt
        if self._span is not None:
            self._span.__exit__(exc_type, exc_val, exc_tb)
        if self.print_time:
            print(self.name, Timer.timer_map[self.name])


def timeit(func):
    """Wall-time print decorator (reference infer_tool.py:60-67)."""

    def run(*args, **kwargs):
        t = time.time()
        res = func(*args, **kwargs)
        print(f"executing '{func.__name__}' costed {time.time() - t:.3f}s")
        return res

    return run


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
