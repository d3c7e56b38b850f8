"""Checkpoints in the reference trainer's ``.ckpt`` layout, with the JAX
package's semantics (``diffsvc_tpu/training/checkpoint.py``): step-named
files, ``.part`` + ``os.replace`` atomic writes, keep-K rotation, best
tracking in ``best_valid.npy``, auto-resume from the highest step.

On disk (``torch.save``): ``model_ckpt_steps_<global_step>.ckpt`` holds
``state_dict`` (``model.fs2.*`` / ``model.denoise_fn.*``, the reference's
keys, so the port's ``Svc`` and the reference load it),
``optimizer_states`` ([AdamW state dict]), ``global_step``, ``epoch``,
``checkpoint_callback_best`` and the task's extra state (``ema_state_dict``
when EMA is on, ``accumulation``).  These are pickles: load only files this
program wrote or that you trust.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.convert import strip_prefix, torch_load


def _save(obj, path: str) -> None:
    tmp = path + ".part"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(work_dir: str, state: Dict, epoch: int, global_step: int,
                    best: Optional[float] = None, num_ckpt_keep: int = 10,
                    save_best: bool = False,
                    monitor_value: Optional[float] = None,
                    monitor_mode: str = "min") -> str:
    """Write ``state`` (the task's :meth:`state_dict`) as step
    ``global_step``; keep the newest ``num_ckpt_keep``; with ``save_best``,
    also ``model_ckpt_best.pt`` when ``monitor_value`` improves."""
    os.makedirs(work_dir, exist_ok=True)
    ckpt = dict(state, epoch=epoch, global_step=global_step,
                checkpoint_callback_best=best)
    path = os.path.join(work_dir, f"model_ckpt_steps_{global_step}.ckpt")
    _save(ckpt, path)

    for old in sorted(_list_ckpts(work_dir), key=_ckpt_step)[:-num_ckpt_keep]:
        os.remove(old)
        print(f"Delete ckpt: {os.path.basename(old)}")

    if save_best and monitor_value is not None:
        best_fn = os.path.join(work_dir, "best_valid.npy")
        prev = np.load(best_fn)[0] if os.path.exists(best_fn) else (
            np.inf if monitor_mode == "min" else -np.inf)
        improved = (monitor_value < prev) if monitor_mode == "min" \
            else (monitor_value > prev)
        if improved:
            np.save(best_fn, [monitor_value])
            _save(ckpt, os.path.join(work_dir, "model_ckpt_best.pt"))
    return path


def _list_ckpts(work_dir: str):
    return glob.glob(os.path.join(work_dir, "model_ckpt_steps_*.ckpt"))


def _ckpt_step(path: str) -> int:
    m = re.findall(r"model_ckpt_steps_(\d+)\.ckpt", path)
    return int(m[0]) if m else -1


def latest_checkpoint(work_dir: str) -> Optional[str]:
    ckpts = _list_ckpts(work_dir)
    return max(ckpts, key=_ckpt_step) if ckpts else None


def restore_checkpoint(work_dir: str
                       ) -> Optional[Tuple[Dict, int, int, Optional[float]]]:
    """Auto-resume from the highest-step checkpoint: (checkpoint, epoch,
    global_step, best) or None."""
    path = latest_checkpoint(work_dir)
    if path is None:
        return None
    ckpt = torch_load(path)
    print(f"| Restored checkpoint {os.path.basename(path)} "
          f"(step {ckpt['global_step']})")
    return (ckpt, ckpt["epoch"], ckpt["global_step"],
            ckpt.get("checkpoint_callback_best"))


def load_params_for_infer(ckpt_path: str) -> Dict[str, torch.Tensor]:
    """The model's state dict (keys without ``model.``) of a checkpoint file
    or the latest one in a directory; the EMA weights when present."""
    if os.path.isdir(ckpt_path):
        ckpt_path = latest_checkpoint(ckpt_path)
    ckpt = torch_load(ckpt_path)
    return ckpt.get("ema_state_dict") or strip_prefix(ckpt["state_dict"],
                                                      "model.")


def simplify_checkpoint(in_path: str, out_path: str) -> None:
    """Strip the optimizer and training state for distribution (reference
    simplify.py)."""
    ckpt = torch_load(in_path)
    _save({"state_dict": ckpt["state_dict"], "epoch": ckpt["epoch"],
           "global_step": ckpt["global_step"]}, out_path)
