"""Strip the optimizer and training state from a checkpoint for
distribution (counterpart of the repository's ``simplify.py``, reference
``simplify.py``), through ``training/checkpoint.simplify_checkpoint``.

    python -m diffsvc_tpu_torch.simplify --proj myproj --steps 100000

reads ``./checkpoints/{proj}/model_ckpt_steps_{steps}.ckpt`` and writes
``./clean_model_ckpt_steps_{steps}.ckpt`` (``state_dict``, ``epoch``,
``global_step``).  It computes nothing on a device.
"""

from __future__ import annotations

from argparse import ArgumentParser

from .training.checkpoint import simplify_checkpoint


def main(argv=None) -> str:
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--proj", type=str, required=True)
    parser.add_argument("--steps", type=str, required=True)
    args = parser.parse_args(argv)
    model_name = f"model_ckpt_steps_{args.steps}.ckpt"
    out = f"./clean_{model_name}"
    simplify_checkpoint(f"./checkpoints/{args.proj}/{model_name}", out)
    print(f"| wrote {out}")
    return out


if __name__ == "__main__":
    main()
