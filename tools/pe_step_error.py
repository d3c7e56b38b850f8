#!/usr/bin/env python3
"""Where the error of one pe training step comes from, on the card.

    python3 tools/pe_step_error.py [--seeds 0 1 2] [--out FILE.json]

One ``PitchExtractionTask`` step at config_24k's pe width (hidden 256, 2
conv layers, 80 mel) on the largest training batch of chip_smoke.py's pe
data (16 synthetic voiced clips at 24 kHz, binarized by the port with the
AC tracker; B=8, T=1024): the loss and every parameter's grad, each run
held against the same step in float64 on the CPU, per init seed:

- ``card``: the card's step as the pe task runs it (true f32
  convolutions, PyTorch's default flags otherwise);
- ``card_benchmark``: the same with ``cudnn.benchmark`` on;
- ``card_no_cudnn``: cuDNN off (PyTorch's own convolutions on cuBLAS);
- ``card_tf32``: the convolutions left at cuDNN's default TF32 (the
  smoke's planted fault);
- ``cpu``: the CPU's f32 step;
- ``card_smooth`` and ``cpu_smooth``: the card's and the CPU's step with
  every ReLU replaced by ``softplus(x, beta=50)`` (and the f64 reference
  likewise).  A ReLU whose input lies within rounding of 0 can take the
  other branch in f32 than in f64, and then passes the whole upstream
  grad where the reference passes none; a smooth activation has no such
  branch, so the gap between a run and its smooth twin is what such flips
  contribute.

Prints, per run and seed, the largest per-parameter rel-L2 and the four
worst parameters; last, one JSON line with every reading.  Runs on the
card only (CUDA is required).
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402  (its helpers; imports no torch)


def pe_batch(workdir: str):
    """chip_smoke.py's pe config and data, binarized, and its largest
    batch."""
    from diffsvc_tpu_torch.config import set_hparams
    from diffsvc_tpu_torch.data.binarizer import binarize
    from diffsvc_tpu_torch.models.hubert import HubertConfig
    from diffsvc_tpu_torch.utils import synth

    cfg_fn = smoke.write_pe_data(workdir)
    synth.write_hubert(smoke.pe_config(workdir)["hubert_path"],
                       HubertConfig())
    hp = set_hparams(config=cfg_fn, exp_name="pe_step_error", reset=True,
                     print_hparams=False)
    binarize(hp, device="cuda")
    return hp, smoke.step_batch(hp)


def worst(run, ref, names):
    rels = sorted(((smoke.rel_l2(g, r), n) for g, r, n in
                   zip(run[1], ref[1], names)), reverse=True)
    return {"loss_rel": smoke.rel_l2(run[0], ref[0]),
            "max_grad_rel": rels[0][0],
            "worst": [(n, r) for r, n in rels[:4]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from diffsvc_tpu_torch.models import nn as fnn
    from diffsvc_tpu_torch.training.pe_task import PitchExtractionTask

    if not torch.cuda.is_available():
        print("pe_step_error: CUDA is required", file=sys.stderr)
        return 1
    cudnn = torch.backends.cudnn
    none = contextlib.nullcontext
    variants = {       # name: (device, ReLU as softplus, swaps)
        "card": ("cuda", False, {}),
        "card_benchmark": ("cuda", False, {cudnn: {"benchmark": True}}),
        "card_no_cudnn": ("cuda", False, {cudnn: {"enabled": False}}),
        "card_tf32": ("cuda", False, {fnn: {"true_f32_convs": none}}),
        "cpu": ("cpu", False, {}),
        "card_smooth": ("cuda", True, {}),
        "cpu_smooth": ("cpu", True, {}),
    }
    out = {"card": smoke.card_line(), "seeds": {}}
    print(out["card"], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        hp, batch = pe_batch(tmp)
    print(f"batch: mels {tuple(batch['mels'].shape)}", flush=True)
    names = PitchExtractionTask(hp, device="cpu").names
    for seed in args.seeds:
        refs = {}
        for smooth in (False, True):
            with smoke.smooth_relus() if smooth else none():
                refs[smooth] = smoke.pe_step(hp, batch, "cpu", f64=True,
                                             seed=seed)
        res = {}
        for name, (device, smooth, swaps) in variants.items():
            with contextlib.ExitStack() as stack:
                if smooth:
                    stack.enter_context(smoke.smooth_relus())
                for mod, attrs in swaps.items():
                    stack.enter_context(smoke.swapped(mod, **attrs))
                run = smoke.pe_step(hp, batch, device, seed=seed)
            r = res[name] = worst(run, refs[smooth], names)
            print(f"seed {seed} {name:15s} vs f64: loss {r['loss_rel']:.3e}, "
                  f"largest grad rel_l2 {r['max_grad_rel']:.3e}; worst "
                  f"{[(n, f'{e:.2e}') for n, e in r['worst']]}", flush=True)
        out["seeds"][seed] = res
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
