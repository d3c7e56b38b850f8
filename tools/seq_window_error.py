#!/usr/bin/env python3
"""How far a (data, seq) grid's window sum is from the unsharded step, on
the card, through K4 and through the plain versions.

    python3 tools/seq_window_error.py [--seeds 0 1] [--out FILE.json]

chip_smoke.py's phase-12 batch (config_44k at full width, B=4, T=4096,
the f32 train stream, a seeded init with a random DiffNet head) per seed,
under two spec ranges: config_44k's own (``spec_min`` -5, ``spec_max``
0) and the per-bin range the binarizer writes back from phase 6's 96
synthetic clips (binarized here first, with phase 6's 3 steps).  For each,
the unsharded step and the sum of the (2, 2) grid's four window shares,
once through the kernels (K4 at the f32 stream, 3xTF32 products) and once
through K4's plain versions (true f32), all on the card; printed: the
largest per-tensor rel-L2 of window sum vs unsharded (plain and K4) and of
K4 vs plain (unsharded and windows), with the tensor that gives it.
Needs one card; about a minute after the kernels' build.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worst(names, a, b, rel_l2):
    r, n = max((rel_l2(x, y), n) for n, x, y in zip(names, a, b))
    return {"rel": r, "tensor": n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("seq_window_error: needs an NVIDIA GPU", file=sys.stderr)
        return 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import yaml

    import chip_smoke as cs
    from diffsvc_tpu_torch.models.hubert import HubertConfig
    from diffsvc_tpu_torch.ops.hopper import _build
    from diffsvc_tpu_torch.parallel import dist
    from diffsvc_tpu_torch.utils import synth

    _build.lib()
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    out = {"card": card, "runs": []}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            cfg = cs.train_config(tmp)
            synth.write_hubert(cfg["hubert_path"], HubertConfig(), seed=2)
            synth.write_nsf_generator(os.path.dirname(cfg["vocoder_ckpt"]),
                                      cs.VOC_H, 1)
            with open(os.path.join(tmp, "own.yaml"), "w") as f:
                yaml.safe_dump(cs.own_batch_config(
                    tmp, cfg["hubert_path"], cfg["vocoder_ckpt"]), f)
            config_hp, _ = cs.seq_hp(tmp)    # config_44k's range
            cs.phase_train_own_batch(dev, tmp, cfg["hubert_path"],
                                     cfg["vocoder_ckpt"])
            binarized_hp, _ = cs.seq_hp(tmp)
        finally:
            os.chdir(cwd)
        for spec, hp in (("config", config_hp), ("binarized", binarized_hp)):
            for seed in args.seeds:
                batch = cs.seq_batch(hp, seed=seed)
                task = cs.seq_task(hp, dev, grid=dist.Grid(1, 1))
                t, noise = task.draws(batch)
                got = {}
                for route in ("k4", "plain"):
                    with (cs.k4_plain() if route == "plain"
                          else contextlib.nullcontext()):
                        got[route, "unsharded"] = task.loss_and_grads(
                            batch, t=t, noise=noise)[1]
                        got[route, "windows"] = cs.seq_shares(
                            task, batch, t, noise)[1]
                rec = {"spec": spec, "seed": seed}
                for key, a, b in (
                        ("windows_vs_unsharded_plain", ("plain", "windows"),
                         ("plain", "unsharded")),
                        ("windows_vs_unsharded_k4", ("k4", "windows"),
                         ("k4", "unsharded")),
                        ("k4_vs_plain_unsharded", ("k4", "unsharded"),
                         ("plain", "unsharded")),
                        ("k4_vs_plain_windows", ("k4", "windows"),
                         ("plain", "windows"))):
                    rec[key] = worst(task.names, got[a], got[b], cs.rel_l2)
                    print(f"[seq-error] {spec} spec range, seed {seed}: "
                          f"{key} {rec[key]['rel']:.3e} "
                          f"({rec[key]['tensor']})", flush=True)
                out["runs"].append(rec)
                del task, got
                torch.cuda.empty_cache()
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
