"""Sampler solver error on a learned denoiser, sampled through K2.

The port's counterpart of ``tools/sampler_quality.py``: train the SVC
diffusion task on synthetic singing (``utils/synth.make_dataset``, the
recipe of ``tools/train_demo_tpu.py``), then, from one shared x_T, sample
each configuration of the grid the fast and turbo serving profiles were
chosen on and compare its mel with a fine-grid probability-flow reference
(DPM-Solver++ at interval 2: its 501 uniform log-SNR targets snap to 403
distinct timesteps, so 403 evaluations; the JAX tool says "~500 NFE").
Every sampler integrates the same learned ODE from the same start, so the
distance to the reference is solver error; the distance to the ground
truth and the mel's range are reported beside it.  Every row is one ``GaussianDiffusion.infer`` call,
one K2 ladder on the card (14 per grid: 12 rows and 2 references).

Reported per configuration: mean |mel - mel_ref| and mean |mel - mel_gt|
over the held-out items (log10-mel, voiced frames, per bin), the NFE and
the range.  Writes ``<out>/summary.json`` (with the card's name and power
limit, the compute dtype and K2's launches) and prints one JSON line on
stdout (every log goes to stderr).

    python -m diffsvc_tpu_torch.tools.sampler_quality [--steps 800]
        [--n-clips 16] [--tiny] [--real-wav WAV] [--keep-ckpt DIR]
        [--reuse-ckpt DIR] [--compute-dtype {f32,bf16}] [--out DIR]
        [--device cpu]

``--compute-dtype`` sets ``diff_compute_dtype`` (f32 by default, as the
JAX tool ran; bf16 is the production serving mode); to compare the two on
one score, train once with ``--keep-ckpt`` and sample again with
``--reuse-ckpt``.  It runs on the card and raises without one; ``--device
cpu`` asks for the CPU, and ``--tiny`` selects the tiny widths only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from .train_demo import (REPO, device_info, launches, log, profile, since,
                         tool_hp)

# the fine-grid reference and its cross-check: (sampler, interval)
REFERENCE = ("dpmpp", 2)
CROSS_REFERENCE = ("plms", 2)
# (sampler, interval, dpmpp grid, x0 clip) of every row
ROWS = [("plms", 20, "lambda", 0.0), ("plms", 50, "lambda", 0.0),
        ("plms", 20, "lambda", 1.0), ("dpmpp", 50, "lambda", 1.0),
        ("dpmpp", 20, "lambda", 0.0), ("dpmpp", 50, "lambda", 0.0),
        ("dpmpp", 50, "t", 0.0),
        # the low-NFE frontier of the turbo profile: intervals 100/150/200
        # are 11/8/6 NFE; plms100_clip is the multistep baseline at 11 NFE,
        # the unclipped dpmpp100 the pure solver error on that grid
        ("dpmpp", 100, "lambda", 1.0), ("dpmpp", 150, "lambda", 1.0),
        ("dpmpp", 200, "lambda", 1.0), ("plms", 100, "lambda", 1.0),
        ("dpmpp", 100, "lambda", 0.0)]
BATCH_KEYS = ("hubert", "mels", "mel2ph", "energy", "f0", "uv")
X_T_SEED = 77       # the shared start draw's torch.Generator seed
DTYPES = {"f32": "float32", "bf16": "bfloat16"}


def row_name(sampler: str, acc: int, grid: str, clip: float) -> str:
    return (f"{sampler}{acc}" + ("_tgrid" if grid == "t" else "")
            + ("_clip" if clip else ""))


def row_nfe(k_step: int, acc: int) -> int:
    """Scan steps + 1: PLMS's order-1 bootstrap calls the denoiser twice,
    DPM-Solver++ evaluates the data prediction once more at t=0."""
    return -(-k_step // acc) + 1


def masked_l1(mel, other, mask, nmel: int) -> float:
    return float((np.abs(mel - other) * mask).sum() / mask.sum() / nmel)


def row_metrics(mel, ref, gt, mask, nmel: int, nfe: int) -> dict:
    """A row's solver error (to the reference), ground-truth error and
    range (a blown-out range is the telltale of multistep overshoot)."""
    return {"nfe": int(nfe),
            "solver_err_l1": round(masked_l1(mel, ref, mask, nmel), 6),
            "gt_err_l1": round(masked_l1(mel, gt, mask, nmel), 6),
            "mel_range": [round(float(mel.min()), 2),
                          round(float(mel.max()), 2)]}


def reference_evals(model) -> int:
    """The denoiser evaluations of the reference ladder (its table's
    length; the lambda grid's repeated timesteps are dropped)."""
    from ..ops.hopper.plms_ladder import dpmpp_eval_tables

    return len(dpmpp_eval_tables(model.tables_np["alphas_cumprod"],
                                 model.K_step, REFERENCE[1],
                                 grid="lambda")[0])


def restore_model(hp, device):
    """The latest checkpoint of ``hp['work_dir']`` (its EMA weights when
    kept) in a GaussianDiffusion on ``device``; returns (model, step)."""
    from ..models.diffusion import GaussianDiffusion
    from ..training import checkpoint as ckpt_lib
    from ..utils.convert import strip_prefix

    ckpt, _, gstep, _ = ckpt_lib.restore_checkpoint(hp["work_dir"])
    sd = ckpt.get("ema_state_dict") or strip_prefix(ckpt["state_dict"],
                                                    "model.")
    model = GaussianDiffusion(hp)
    model.load_state_dict(sd)
    return model.to(device).eval(), int(gstep)


def held_out(hp, device):
    """The first two test items, collated: (batch on ``device``, the voiced
    mask [B, T, 1] and the ground-truth mel, both numpy)."""
    import torch

    from ..data.dataset import FastSpeechDataset

    ds = FastSpeechDataset("test", hp, shuffle=False)
    batch = ds.collater([ds[i] for i in range(min(2, len(ds)))])
    jb = {k: torch.as_tensor(batch[k]).to(device) for k in BATCH_KEYS
          if batch.get(k) is not None}
    mask = np.asarray(batch["mel2ph"] > 0)[..., None]
    return jb, mask, np.asarray(batch["mels"])


def shared_x_T(b: int, t_mel: int, nmel: int):
    """The one start draw every row shares (on the CPU, so every device
    starts from the same numbers)."""
    import torch

    g = torch.Generator().manual_seed(X_T_SEED)
    return torch.randn((b, t_mel, nmel), generator=g)


def sample(model, hp, jb, x_T, sampler, acc, grid="lambda", clip=0.0):
    """One row: ``infer`` from x_T with the row's sampler settings (K2 on
    the card); the mel [B, T, M] as numpy.  The settings go into
    ``model.hp``, which ``infer`` reads."""
    model.hp = dict(hp, sampler=sampler, dpmpp_grid=grid,
                    sampler_clip_x0=clip)
    out = model.infer(jb, speedup=acc, init_noise=x_T)
    return out["mel_out"].float().cpu().numpy()


def run_grid(model, hp, jb, x_T, mask, gt) -> dict:
    """The references and every row of :data:`ROWS`: their results by name
    ("samplers"), the cross-reference L1, the mels by name, K2's launches
    and each ladder's wall seconds (host clock, the mel read back)."""
    nmel = int(hp["audio_num_mel_bins"])
    k_step = int(hp.get("K_step", hp.get("timesteps", 1000)))
    counts = launches()
    mels, walls = {}, {}

    def timed(name, *row):
        t0 = time.time()
        mels[name] = sample(model, hp, jb, x_T, *row)
        walls[name] = round(time.time() - t0, 4)
        return mels[name]

    log("| sampling (reference: dpmpp interval 2) ...")
    ref = timed("reference", *REFERENCE)
    # fairness: a fine-grid PLMS must converge to the same solution, or the
    # reference is solver-biased
    cross = masked_l1(timed("cross_reference", *CROSS_REFERENCE), ref, mask,
                      nmel)
    log(f"| cross-reference |plms_fine - dpmpp_fine| = {cross:.5f}/bin")
    results = {}
    for sampler, acc, grid, clip in ROWS:
        name = row_name(sampler, acc, grid, clip)
        r = results[name] = row_metrics(
            timed(name, sampler, acc, grid, clip), ref, gt, mask, nmel,
            row_nfe(k_step, acc))
        log(f"| {name:16s} NFE {r['nfe']:3d}  |mel-ref| "
            f"{r['solver_err_l1']:.5f}  |mel-gt| {r['gt_err_l1']:.4f}  "
            f"range {r['mel_range']}  {walls[name]:.3f}s")
    return {"samplers": results, "cross_reference_l1": round(cross, 6),
            "mels": mels, "k2_launches": since(counts)["K2"],
            "row_wall_s": walls}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--n-clips", type=int, default=16,
                    help="dataset size; few clips and many steps give an "
                         "overfit score whose probability-flow ODE leaves "
                         "the data manifold")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths (8 kHz, 16 mel, DiffNet 32 x 4)")
    ap.add_argument("--real-wav", default=None,
                    help="train on non-overlapping windows of this vocal "
                         "recording (utils/synth.make_real_dataset) instead "
                         "of synthetic singing")
    ap.add_argument("--out",
                    default=os.path.join(REPO, "runs/torch_sampler_quality"))
    ap.add_argument("--keep-ckpt", default=None,
                    help="after training, copy the work dir here for a "
                         "later --reuse-ckpt")
    ap.add_argument("--reuse-ckpt", default=None,
                    help="skip training; restore from this kept work dir "
                         "(the dataset is rebuilt from the same recipe, so "
                         "--n-clips, --tiny and --real-wav must match)")
    ap.add_argument("--compute-dtype", default="f32", choices=tuple(DTYPES),
                    help="diff_compute_dtype of the sampling (and of a "
                         "training run)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def prepare(args, scratch: str, device):
    """Build and binarize the data under ``scratch`` on ``device``, then
    train (or copy a kept work dir); returns (the resolved hparams, the
    training's wall seconds or None)."""
    import yaml

    from ..config.hparams import set_hparams
    from ..data.binarizer import binarize
    from ..training.trainer import Trainer
    from ..utils import synth

    p = profile(args.tiny)
    log("| building dataset ...")
    if args.real_wav:
        n_real = synth.make_real_dataset(f"{scratch}/raw", args.real_wav,
                                         sr=p["sr"], dur=p["dur"],
                                         n_clips=args.n_clips)
        log(f"| real recording: {args.real_wav} -> {n_real} windows")
    else:
        synth.make_dataset(f"{scratch}/raw", sr=p["sr"], dur=p["dur"],
                           n_clips=args.n_clips)
    hp_dict = tool_hp(
        scratch, p, vocoder_ckpt="",   # a mel-domain study: no vocoder
        max_updates=args.steps,
        # a checkpoint every <= 1000 steps, not only at the end
        val_check_interval=max(min(args.steps, 1000), 100),
        num_sanity_val_steps=0, num_valid_plots=0, num_ckpt_keep=2,
        diff_compute_dtype=DTYPES[args.compute_dtype])
    cfg_path = f"{scratch}/config.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(hp_dict, f)

    log("| binarizing ...")
    hp = set_hparams(config=cfg_path, exp_name="sampler_q", reset=True,
                     print_hparams=False)
    binarize(hp, device=device)
    if args.reuse_ckpt:
        shutil.copytree(args.reuse_ckpt, hp["work_dir"], dirs_exist_ok=True)
        log(f"| reusing checkpoint from {args.reuse_ckpt}")
        return hp, None
    log(f"| training {args.steps} steps on {device} ...")
    t0 = time.time()
    # nothing is plotted (num_valid_plots 0): no TensorBoard writer
    Trainer(hp, log_writer=False, device=device).fit()
    train_wall = round(time.time() - t0, 1)
    log(f"| trained in {train_wall}s")
    if args.keep_ckpt:
        shutil.copytree(hp["work_dir"], args.keep_ckpt, dirs_exist_ok=True)
        log(f"| kept checkpoint at {args.keep_ckpt}")
    return hp, train_wall


def run(args, scratch: str) -> dict:
    """:func:`prepare`, then the grid from the latest checkpoint; returns
    the summary (``summary["hp"]``: the resolved hparams).  Raises without
    a card unless the CPU was asked for."""
    from ..infer.svc import default_device

    device = default_device(args.device)
    info = device_info(device)
    log(f"| device: {info['device']} ({info['card']}); scratch {scratch}")
    hp, train_wall = prepare(args, scratch, device)
    model, gstep = restore_model(hp, device)
    jb, mask, gt = held_out(hp, device)
    b, t_mel = jb["mel2ph"].shape
    x_T = shared_x_T(b, t_mel, int(hp["audio_num_mel_bins"]))
    grid = run_grid(model, hp, jb, x_T, mask, gt)
    return {
        **info,
        "dims": profile(args.tiny)["label"],
        "data": (f"real:{os.path.basename(args.real_wav)}" if args.real_wav
                 else "synthetic"),
        "compute_dtype": args.compute_dtype,
        "train_steps": gstep, "train_wall_s": train_wall,
        "held_out_items": int(b),
        "reference": (f"dpmpp interval 2 ({reference_evals(model)} "
                      "evaluations), shared x_T"),
        "cross_reference_l1": grid["cross_reference_l1"],
        "k2_launches": grid["k2_launches"],
        "row_wall_s": grid["row_wall_s"],
        "samplers": grid["samplers"],
        "hp": hp,
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="sampler_quality_") as scratch, \
            contextlib.redirect_stdout(sys.stderr):
        summary = run(args, scratch)
    del summary["hp"]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"sampler_quality": summary["samplers"],
                      "compute_dtype": summary["compute_dtype"],
                      "card": summary["card"]}))
    return summary


if __name__ == "__main__":
    main()
