"""Training entry point of the port (reference ``run.py``, the JAX package's
``run.py``):

    python -m diffsvc_tpu_torch.run --config configs/config_44k.yaml \
        --exp_name myexp --reset              # train (auto-resumes)
    python -m diffsvc_tpu_torch.run --config ... --exp_name myexp --validate
    python -m diffsvc_tpu_torch.run --config ... --exp_name myexp --infer

Trains the config's ``task_cls`` (``SVCTask``, or the pe task for a
``...PitchExtractionTask``) on one card (``--device cpu`` asks for the CPU;
there is no fallback).  ``--validate`` runs one validation pass on the
latest checkpoint; ``--infer`` renders the test split from it
(``training/test_runner.py``).  Vocoder training is not ported.
"""

import argparse

from .config import hparams, set_hparams
from .training.trainer import Trainer, vocoder_weights_available


def device_arg(argv=None) -> str:
    """``--device`` of the command lines (default ``cuda``); the other
    flags are ``set_hparams``'s."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_known_args(argv)[0].device


def run_infer(trainer: Trainer) -> str:
    """``--infer``, as the JAX package's ``run.py:25-49``: the latest
    checkpoint of ``work_dir`` (its EMA weights too; fresh weights without
    one), the configured vocoder (mels only when its weights are missing or
    it cannot load), then the test split through ``run_test``.  Returns the
    generated directory."""
    from .training import checkpoint as ckpt_lib
    from .training.test_runner import run_test
    from .vocoders.base import get_vocoder_cls

    hp = trainer.hp
    restored = ckpt_lib.restore_checkpoint(hp["work_dir"])
    step = 0
    if restored is not None:
        ckpt, _, step, _ = restored
        trainer.task.load_state_dict(ckpt)
    trainer.global_step = step
    vocoder = None
    if not vocoder_weights_available(hp):
        print(f"| no vocoder weights at {hp.get('vocoder_ckpt', '')!r}; "
              "saving mels only")
    else:
        try:
            vocoder = get_vocoder_cls(hp)(hp, device=trainer.task.device)
        except Exception as e:
            print(f"| vocoder unavailable ({e}); saving mels only")
    return run_test(hp, trainer.task, vocoder, global_step=step)


def run_task(hp, device=None) -> Trainer:
    """Train (or ``validate``, or ``infer``) on ``device``, by default the
    card."""
    if not hp.get("task_cls", ""):
        raise ValueError("config must define task_cls")
    # --infer logs nothing: no TensorBoard writer (nor its vocoder)
    trainer = Trainer(hp, device=device,
                      log_writer=False if hp.get("infer") else None)
    if hp.get("infer"):
        run_infer(trainer)
    elif hp.get("validate"):
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
