"""Training entry point of the port (reference ``run.py``, the JAX package's
``run.py``):

    python -m diffsvc_tpu_torch.run --config configs/config_44k.yaml \
        --exp_name myexp --reset              # train (auto-resumes)
    python -m diffsvc_tpu_torch.run --config ... --exp_name myexp --validate

Trains ``SVCTask`` on one card (``--device cpu`` asks for the CPU; there is
no fallback).  ``--infer`` (the test-split runner) and the pe / vocoder
tasks are not ported yet and raise NotImplementedError.
"""

import argparse

from .config import hparams, set_hparams
from .training.trainer import Trainer


def device_arg(argv=None) -> str:
    """``--device`` of the command lines (default ``cuda``); the other
    flags are ``set_hparams``'s."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_known_args(argv)[0].device


def run_task(hp, device=None) -> Trainer:
    """Train (or ``validate``) on ``device``, by default the card."""
    if not hp.get("task_cls", ""):
        raise ValueError("config must define task_cls")
    if hp.get("infer"):
        raise NotImplementedError("--infer (the test-split runner) is not "
                                  "ported to torch yet")
    trainer = Trainer(hp, device=device)
    if hp.get("validate"):
        from .data.dataset import FastSpeechDataset

        trainer.restore()
        trainer.validate(FastSpeechDataset("valid", hp, shuffle=False),
                         int(hp.get("frames_multiple", 128)))
    else:
        trainer.fit()
    return trainer


if __name__ == "__main__":
    set_hparams(print_hparams=False)
    run_task(hparams, device=device_arg())
