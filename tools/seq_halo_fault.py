#!/usr/bin/env python3
"""How much a seq window's halo that is too short moves the step, on the
CPU, at config_44k's width.

    python3 tools/seq_halo_fault.py [--t 512] [--b 1] [--layers 20]
        [--offsets 0 -1 -2 -5] [--init jax|torch]

One training step of config_44k's model (128 mel, DiffNet 384 channels,
``--layers`` layers in cycles of 4, f32 stream; the plain versions of the
kernels, as every CPU run) on a random batch of ``--b`` clips of ``--t``
frames, unsharded and as the sum of a (1, 2) grid's two window shares with
the halo moved by each of ``--offsets`` from the receptive radius H.
Printed per offset: the loss's relative error and the grads' rel-L2 (over
all of them, and the largest per tensor) against the unsharded step.
``--init jax`` is the task's seeded init (JAX's: kaiming-normal convs) with
a DiffNet head drawn from a seed, ``torch`` every module at torch's default
init (``utils/synth.randomize``).  A halo of H - 1 reaches an own frame
only through the path of every layer's furthest tap; this shows how far
that path carries a change at a given depth.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, default=512)
    ap.add_argument("--b", type=int, default=1)
    ap.add_argument("--layers", type=int, default=20)
    ap.add_argument("--offsets", type=int, nargs="+", default=[0, -1, -2, -5])
    ap.add_argument("--init", choices=("jax", "torch"), default="jax")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from diffsvc_tpu_torch.config import HParams, set_hparams
    from diffsvc_tpu_torch.parallel import dist
    from diffsvc_tpu_torch.training.task import SVCTask
    from diffsvc_tpu_torch.utils import synth

    hp = set_hparams(config=os.path.join(ROOT, "configs", "config_44k.yaml"),
                     exp_name="seq_halo_fault", print_hparams=False,
                     global_hparams=False)
    hp = HParams(hp, diffnet_train_stream_dtype="f32",
                 residual_layers=args.layers)
    t, b, units = args.t, args.b, args.t // 2
    rng = np.random.RandomState(0)
    batch = {"hubert": rng.randn(b, units, int(hp["hidden_size"])).astype(
                 np.float32) * 0.3,
             "mel2ph": np.tile(np.arange(t) * units // t + 1, (b, 1)
                               ).astype(np.int32),
             "f0": (7.6 + 0.2 * rng.randn(b, t)).astype(np.float32),
             "uv": np.zeros((b, t), np.float32),
             "energy": np.zeros((b, t), np.float32),
             "mels": (rng.randn(b, t, int(hp["audio_num_mel_bins"])) - 3.0
                      ).astype(np.float32),
             "sample_mask": np.ones(b, np.float32)}
    task = SVCTask(hp, device="cpu", grid=dist.Grid(1, 1))
    if args.init == "torch":
        synth.randomize(task.model, 0)
    else:
        head = task.model.denoise_fn.output_projection
        with torch.no_grad():
            head.weight.copy_(torch.randn(head.weight.shape, generator=torch.
                                          Generator().manual_seed(11)) * 0.05)
    draws = task.draws(batch)
    l0, g0 = task.loss_and_grads(batch, t=draws[0], noise=draws[1])
    h = dist.halo(task.model.denoise_fn, t)
    real = dist.halo
    task.grid = dist.Grid(1, 2)
    print(f"config_44k width, {args.layers} layers (H={h}), B={b} T={t}, "
          f"{args.init} init; CPU, plain versions")
    for off in args.offsets:
        dist.halo = lambda net, tt: real(net, tt) + off
        try:
            loss, grads = 0.0, None
            for j in range(2):
                lo, g = task.loss_and_grads(batch, t=draws[0],
                                            noise=draws[1],
                                            frames=dist.frames(t, j, 2))
                loss = loss + lo
                grads = g if grads is None else \
                    [x + y for x, y in zip(grads, g)]
        finally:
            dist.halo = real
        num = sum(float((x - y).double().pow(2).sum())
                  for x, y in zip(grads, g0))
        den = sum(float(y.double().pow(2).sum()) for y in g0)
        per = max(float((x - y).double().norm()
                        / y.double().norm().clamp_min(1e-30))
                  for x, y in zip(grads, g0))
        print(f"halo H{off:+d}: loss {abs(float(loss - l0)) / abs(float(l0)):.3e}"
              f", grads rel_l2 {(num / den) ** 0.5:.3e} (all), {per:.3e} "
              "(largest per tensor)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
