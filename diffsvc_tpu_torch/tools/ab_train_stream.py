"""Training-numerics A/B of the training stack's stream dtype: the same
step sequence trained three ways, the loss curves compared.

The port's counterpart of ``tools/ab_train_stream.py`` (the evidence
behind the default ``diffnet_train_stream_dtype: bf16``).  Three legs from
one initial state, on the same synthetic singing-shaped batches (cycled)
and the same t and noise per step (drawn once per step from a
``torch.Generator`` seeded with the step, as JAX's ``PRNGKey(step)``, and
given to every leg):

  * ``batched_bf16``: the bf16 stream; at B=24 x T=1024 the route rule
    (``diffnet.train_route``) sends it to K4
  * ``kernel_f32``: the f32 stream; at B=24 x T=1024 the route rule sends
    it to K5, the per-sample backward
  * ``scan``: ``diffnet_pallas_train: off``, the JAX package's f32 scan,
    which the port computes with K4 at the f32 stream

Pass criteria, the JAX tool's (``:171``, ``:175``): every curve falls
(the mean of its last tenth below that of its first), and the bf16 leg's
gap to the scan over the last tenth is at most 3 x the f32 leg's gap or
1% of the scan's loss, whichever is larger.

Writes ``<out>/result.json`` (the JAX tool's keys, plus each leg's route
and kernel launches, the card's name and power limit, and ``failures``:
the asserts that failed) and prints one JSON line on stdout (every log goes
to stderr); a failed assert raises after the file is written.

    python -m diffsvc_tpu_torch.tools.ab_train_stream [--steps 200]
        [--batch 24] [--frames 1024] [--out DIR] [--tiny] [--device cpu]

It runs on the card and raises without one; ``--device cpu`` asks for the
CPU.  ``--tiny`` selects B=2, T=256, C=128, L=4, 16 mel and 8 steps (the
JAX tool's ``--smoke``), not the device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from .train_demo import REPO, device_info, log

LEGS = (("batched_bf16", dict(diffnet_pallas_train="auto",
                              diffnet_train_stream_dtype="bf16")),
        ("kernel_f32", dict(diffnet_pallas_train="auto",
                            diffnet_train_stream_dtype="f32")),
        ("scan", dict(diffnet_pallas_train="off")))
N_BATCHES = 4


def dims(args) -> dict:
    """B, T, C, L, the dilation cycle, hidden, mel bins and steps
    (``tools/ab_train_stream.py:67-71``)."""
    if args.tiny:
        return dict(B=2, T=256, C=128, L=4, CYC=2, H=256, n_mel=16,
                    steps=args.steps or 8)
    return dict(B=args.batch, T=args.frames, C=384, L=20, CYC=4, H=256,
                n_mel=128, steps=args.steps or 200)


def base_hp(d: dict) -> dict:
    """The tool's hparams (``tools/ab_train_stream.py:74-88``)."""
    n_mel = d["n_mel"]
    return dict(
        audio_num_mel_bins=n_mel, hidden_size=d["H"],
        residual_layers=d["L"], residual_channels=d["C"],
        dilation_cycle_length=d["CYC"], timesteps=1000, K_step=1000,
        diff_loss_type="l2", schedule_type="linear", max_beta=0.02,
        keep_bins=n_mel, spec_min=[-5.0], spec_max=[0.0], no_fs2=True,
        use_pitch_embed=True, use_energy_embed=False, use_spk_id=False,
        use_spk_embed=False, use_uv=False, pitch_norm="log", f0_bin=256,
        f0_min=40.0, f0_max=1100.0, lr=4e-4, scheduler="step_lr",
        decay_steps=40000, optimizer_adam_beta1=0.9,
        optimizer_adam_beta2=0.98, weight_decay=0, clip_grad_norm=1,
        accumulate_grad_batches=1, seed=1234)


def make_batch(d: dict, i: int) -> dict:
    """Batch ``i``: harmonic mel ridges that follow a vibrato f0 line,
    units as a random projection (``tools/ab_train_stream.py:94-117``, the
    same numpy draws)."""
    B, T, n_mel, H = d["B"], d["T"], d["n_mel"], d["H"]
    t_ph = T * 128 // 320
    r = np.random.RandomState(100 + i)
    f0_hz = 220.0 * 2 ** (r.randn(B, 1) * 0.2 +
                          0.05 * np.sin(np.linspace(0, 12, T))[None, :])
    mel = np.zeros((B, T, n_mel), np.float32)
    bins = (np.log(f0_hz / 40.0) / np.log(1100.0 / 40.0) * n_mel)
    for k in range(1, 5):
        bk = np.clip(bins * k / 2, 0, n_mel - 1).astype(np.int32)
        for b in range(B):
            mel[b, np.arange(T), bk[b]] += 1.2 / k
    mel = mel * 2.0 - 4.0 + r.randn(B, T, n_mel).astype(np.float32) * 0.1
    mel2ph = np.clip((np.arange(T)[None, :] * t_ph // T) + 1, 1, t_ph
                     ).astype(np.int32) * np.ones((B, 1), np.int32)
    hub = r.randn(B, t_ph, H).astype(np.float32) * 0.1
    return {"hubert": hub, "mel2ph": mel2ph,
            "f0": np.asarray(np.log2(f0_hz) * np.ones((1, T)), np.float32),
            "uv": np.zeros((B, T), np.float32),
            "energy": np.zeros((B, T), np.float32), "mels": mel}


def step_draws(step: int, d: dict, k_step: int, device):
    """Step ``step``'s t [B] and noise [B, T, M], the same for every leg."""
    g = torch.Generator(device=device).manual_seed(step)
    t = torch.randint(0, k_step, (d["B"],), generator=g, device=device)
    noise = torch.randn((d["B"], d["T"], d["n_mel"]), generator=g,
                        device=device)
    return t, noise


def counters() -> dict:
    """K4's forward and backward calls, its backward calls at the f32
    stream, and K5's backward calls."""
    from ..ops.hopper import diffnet_stack_per_sample, diffnet_stack_train

    return {"K4": diffnet_stack_train.launches,
            "K4_bwd": diffnet_stack_train.bwd_launches,
            "K4_bwd_f32": diffnet_stack_train.bwd_launches_f32,
            "K5": diffnet_stack_per_sample.launches}


def leg_route(hp, d: dict) -> str:
    from ..models import diffnet

    return diffnet.train_route(
        d["L"], d["CYC"], d["T"], d["C"], d["B"],
        str(hp.get("diffnet_train_stream_dtype", "bf16")),
        pallas=str(hp.get("diffnet_pallas_train", "auto")))


def train_legs(d: dict, device, legs=LEGS) -> dict:
    """Train every leg for ``d["steps"]`` steps, interleaved step by step
    on one draw per step; returns {leg: {"curve", "route", "launches",
    "wall_s"}}."""
    from ..config import HParams
    from ..training.task import SVCTask

    hp0 = base_hp(d)
    tasks = {name: SVCTask(HParams(dict(hp0, **extra)), device=device)
             for name, extra in legs}
    first = next(iter(tasks.values()))
    init = {k: v.clone() for k, v in first.model.state_dict().items()}
    for task in tasks.values():       # one initial state for every leg
        task.model.load_state_dict(init)
    batches = [make_batch(d, i) for i in range(N_BATCHES)]
    out = {name: {"curve": [], "route": leg_route(task.hp, d),
                  "launches": dict.fromkeys(counters(), 0), "wall_s": 0.0}
           for name, task in tasks.items()}
    for s in range(d["steps"]):
        t, noise = step_draws(s, d, first.model.K_step, device)
        for name, task in tasks.items():
            rec = out[name]
            before, t0 = counters(), time.time()
            m = task.train_step(batches[s % N_BATCHES], t=t, noise=noise)
            rec["curve"].append(float(m["loss"]))    # waits for the step
            rec["wall_s"] += time.time() - t0
            for k, v in counters().items():
                rec["launches"][k] += v - before[k]
    for name, rec in out.items():
        c, w = rec["curve"], rec["wall_s"]
        log(f"| {name} ({rec['route']}): loss[0]={c[0]:.5f} "
            f"loss[-5:]={[round(x, 5) for x in c[-5:]]} wall={w:.0f}s "
            f"({w / d['steps'] * 1e3:.1f} ms/step incl host) launches "
            f"{rec['launches']}")
    return out


def tail_mean(curve, steps: int) -> float:
    return float(np.mean(curve[-max(1, steps // 10):]))


def head_mean(curve, steps: int) -> float:
    return float(np.mean(curve[:max(1, steps // 10)]))


def compare(curves: dict, steps: int) -> dict:
    """The JAX tool's comparison of the three curves."""
    t_scan, t_f32, t_bf16 = (tail_mean(curves[n], steps) for n in
                             ("scan", "kernel_f32", "batched_bf16"))
    gap_f32, gap_bf16 = abs(t_f32 - t_scan), abs(t_bf16 - t_scan)
    return {"tail_mean_loss": {"scan": t_scan, "kernel_f32": t_f32,
                               "batched_bf16": t_bf16},
            "gap_vs_scan": {"kernel_f32": gap_f32, "batched_bf16": gap_bf16},
            "bf16_rel_gap": gap_bf16 / max(t_scan, 1e-9)}


def failures(curves: dict, steps: int) -> list:
    """The JAX tool's two asserts, as messages (empty: both hold): every
    curve falls, and the bf16 stream's gap to the scan stays within 3x the
    f32 kernel's or 1% of the scan's loss."""
    out = [f"{n}: loss did not decrease ({head_mean(c, steps):.5f} -> "
           f"{tail_mean(c, steps):.5f})" for n, c in curves.items()
           if not tail_mean(c, steps) < head_mean(c, steps)]
    r = compare(curves, steps)
    gap_f32, gap_bf16 = (r["gap_vs_scan"][k] for k in ("kernel_f32",
                                                       "batched_bf16"))
    limit = max(3 * gap_f32, 0.01 * r["tail_mean_loss"]["scan"])
    if not gap_bf16 <= limit:
        out.append(f"bf16 gap {gap_bf16:.3e} over its limit {limit:.3e} "
                   f"(f32 gap {gap_f32:.3e})")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=None,
                    help="default 200 (--tiny: 8)")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--out", default=None,
                    help="default runs/torch_ab_train_stream (--tiny: "
                    "runs/torch_ab_train_stream_tiny)")
    ap.add_argument("--tiny", action="store_true",
                    help="B=2, T=256, C=128, L=4, 16 mel, 8 steps")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = os.path.join(REPO, "runs", "torch_ab_train_stream"
                                + ("_tiny" if args.tiny else ""))
    return args


def run(args) -> dict:
    """Train the three legs; returns the result (the JAX tool's keys,
    plus ``legs``: each leg's route, launches and wall seconds).  Raises
    without a card unless the CPU was asked for."""
    from ..infer.svc import default_device

    device = default_device(args.device)
    info = device_info(device)
    log(f"| device: {info['device']} ({info['card']})")
    d = dims(args)
    legs = train_legs(d, device)
    curves = {name: rec.pop("curve") for name, rec in legs.items()}
    r = compare(curves, d["steps"])
    log(f"| tail means: scan {r['tail_mean_loss']['scan']:.5f}  f32-kernel "
        f"{r['tail_mean_loss']['kernel_f32']:.5f}  bf16 "
        f"{r['tail_mean_loss']['batched_bf16']:.5f}  (bf16 rel gap "
        f"{r['bf16_rel_gap']:.2%})")
    return {**info,
            "dims": {k: d[k] for k in ("B", "T", "C", "L")}
            | {"steps": d["steps"]},
            **r, "curves": curves, "legs": legs}


def main(argv=None) -> dict:
    args = parse_args(argv)
    with contextlib.redirect_stdout(sys.stderr):
        result = run(args)
    failed = result["failures"] = failures(result["curves"],
                                           result["dims"]["steps"])
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    if failed:
        raise RuntimeError(f"A/B failed: {failed}")
    log("| AB PASS")
    print(json.dumps({k: v for k, v in result.items() if k != "curves"}))
    return result


if __name__ == "__main__":
    main()
