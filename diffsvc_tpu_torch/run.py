"""Training entry point of the port (reference ``run.py``, the JAX package's
``run.py``):

    python -m diffsvc_tpu_torch.run --config configs/config_44k.yaml \
        --exp_name myexp --reset              # train (auto-resumes)
    python -m diffsvc_tpu_torch.run --config ... --exp_name myexp --validate

Trains ``SVCTask`` on one device (the card when there is one).  ``--infer``
(the test-split runner) and the pe / vocoder tasks are not ported yet and
raise NotImplementedError.
"""

from .config import hparams, set_hparams
from .training.trainer import Trainer


def run_task(hp) -> Trainer:
    if not hp.get("task_cls", ""):
        raise ValueError("config must define task_cls")
    if hp.get("infer"):
        raise NotImplementedError("--infer (the test-split runner) is not "
                                  "ported to torch yet")
    trainer = Trainer(hp)
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
    run_task(hparams)
