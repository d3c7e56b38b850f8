"""Training entry point of the port (reference ``run.py``, the JAX package's
``run.py``):

    python -m diffsvc_tpu_torch.run --config configs/config_44k.yaml \
        --exp_name myexp --reset              # train (auto-resumes)
    python -m diffsvc_tpu_torch.run --config ... --exp_name myexp --validate
    python -m diffsvc_tpu_torch.run --config ... --exp_name myexp --infer

Trains the config's ``task_cls`` (``SVCTask``, or the pe task for a
``...PitchExtractionTask``) on the card (``--device cpu`` asks for the CPU;
there is no fallback).  On N cards, one process per card:

    torchrun --nproc_per_node N -m diffsvc_tpu_torch.run --config ...

or ``distributed: true`` with ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
``WORLD_SIZE`` set (``parallel/dist.py``: nccl, or ``dist_backend: gloo``).
``mesh_axes: data,seq`` with ``mesh_shape: [d, s]`` (d s = N) in the
config lays the N ranks out as a (data, seq) grid: sequence-parallel
training, each rank on its rows and its window of frames
(``training/task.py``).
``--validate`` runs one validation pass on the latest checkpoint;
``--infer`` renders the test split from it (``training/test_runner.py``);
both on rank 0 alone.  A vocoder ``task_cls`` (e.g.
``training.task.vocoder.HifiGanTask``) trains the config's vocoder family
adversarially (``training/vocoder_task.train_vocoder``: hifigan, istft or
pwg) on one device.
"""

import argparse

from .config import hparams, set_hparams
from .parallel import dist
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


def run_task(hp, device=None):
    """Train (or ``validate``, or ``infer``) on ``device``, by default the
    card; under torchrun (or ``distributed: true``) one rank of
    data-parallel training.  Returns the Trainer, or for a vocoder
    ``task_cls`` the trained ``VocoderTask``."""
    if not hp.get("task_cls", ""):
        raise ValueError("config must define task_cls")
    dist.maybe_initialize_distributed(hp, device=device)
    grid = dist.grid(hp)     # raises for a shape that is not the world's
    if "vocoder" in str(hp["task_cls"]).lower():
        if grid.seq > 1:
            raise ValueError(f"a vocoder task_cls ({hp['task_cls']}) trains "
                             "without a seq axis (mesh_shape "
                             f"{hp.get('mesh_shape')}), as the JAX package's "
                             "vocoder task has no mesh")
        # adversarial vocoder training has its own loop (crops of raw
        # waveforms, D then G steps), as in the JAX package's run.py
        from .training.vocoder_task import train_vocoder

        return train_vocoder(hp, device=device)
    # --infer logs nothing: no TensorBoard writer (nor its vocoder)
    trainer = Trainer(hp, device=device,
                      log_writer=False if hp.get("infer") else None)
    if (hp.get("infer") or hp.get("validate")) and not trainer.is_rank0:
        return trainer
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
    dist.destroy()
