"""Training demo: ``Trainer.fit`` at the production 44.1 kHz widths on the
card for a few hundred steps, with validation sampling (K2) and its audio
vocoded (K3) by a random-weight NSF-HiFiGAN, then a fresh ``Trainer`` that
resumes from the latest checkpoint and trains on: the training product end
to end.

The port's counterpart of ``tools/train_demo_tpu.py``: the same synthetic
singing (``utils/synth.make_dataset``: harmonic voices with vibrato and
phrase gaps, sidecar units from a fixed projection of the framed audio),
binarized by the port's binarizer, the same hparams and the same asserts
(the resumed step count; from 50 steps on, a validation loss that fell).
The validation vocoder is ``utils/synth.write_nsf_generator`` at the
openvpi widths of the JAX tool's ``make_nsf_vocoder_ckpt``; its random
weights are not the JAX tool's.

Writes ``<out>/summary.json`` (the JAX tool's keys, plus the card's name
and power limit, the training route, K2-K5's launches over each fit and the
last validation wav's length and RMS) and ``<out>/config.yaml``, and prints
one JSON line on stdout (every log goes to stderr).

    python -m diffsvc_tpu_torch.tools.train_demo [--steps 300]
        [--resume-steps 100] [--val-interval 100] [--out DIR] [--tiny]
        [--device cpu]

It runs on the card and raises without one; ``--device cpu`` asks for the
CPU.  ``--tiny`` selects the tiny widths (8 kHz, 16 mel, DiffNet 32 x 4),
not the device.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the openvpi 44.1 kHz NSF-HiFiGAN (make_nsf_vocoder_ckpt's widths)
NSF_44K = dict(num_mels=128, upsample_initial_channel=512,
               upsample_rates=[8, 8, 2, 2, 2],
               upsample_kernel_sizes=[16, 16, 4, 4, 4], resblock="1",
               resblock_kernel_sizes=[3, 7, 11],
               resblock_dilation_sizes=[[1, 3, 5]] * 3, sampling_rate=44100,
               n_fft=2048, win_size=2048, hop_size=512, fmin=40, fmax=16000)
# the same generator at the tiny profile's rate and hop
NSF_TINY = dict(num_mels=16, upsample_initial_channel=64,
                upsample_rates=[4, 4, 4], upsample_kernel_sizes=[8, 8, 8],
                resblock="1", resblock_kernel_sizes=[3, 5],
                resblock_dilation_sizes=[[1, 3], [1, 3]], sampling_rate=8000,
                n_fft=256, win_size=256, hop_size=64, fmin=40, fmax=3500)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def profile(tiny: bool) -> dict:
    """Rate, mel and model widths (``tools/sampler_quality.py:83-92``)."""
    if tiny:
        return dict(sr=8000, hop=64, nfft=256, nmel=16, dur=1.5,
                    dims=dict(hidden_size=256, residual_layers=4,
                              residual_channels=32, fmax=3500),
                    label="tiny", vocoder=NSF_TINY)
    return dict(sr=44100, hop=512, nfft=2048, nmel=128, dur=2.0,
                dims=dict(hidden_size=256, residual_layers=20,
                          residual_channels=384, fmax=16000),
                label="production 44.1k", vocoder=NSF_44K)


def tool_hp(scratch: str, p: dict, **overrides) -> dict:
    """The hparams both tools share (``tools/train_demo_tpu.py:219-249``,
    ``tools/sampler_quality.py:102-134``), paths under ``scratch``."""
    sr, nmel, nfft = p["sr"], p["nmel"], p["nfft"]
    hp = dict(
        audio_sample_rate=sr, audio_num_mel_bins=nmel, fft_size=nfft,
        hop_size=p["hop"], win_size=nfft, fmin=40,
        dilation_cycle_length=4, timesteps=1000, K_step=1000,
        diff_loss_type="l2", schedule_type="linear", max_beta=0.02,
        keep_bins=nmel, spec_min=[-5.0], spec_max=[0.0],
        no_fs2=True, use_pitch_embed=True, use_energy_embed=False,
        use_spk_id=False, use_spk_embed=False, use_uv=False,
        pitch_norm="log", f0_bin=256, f0_min=40.0, f0_max=1100.0,
        use_nsf=True, use_crepe=False, use_vec=False,
        vocoder="NsfHifiGAN", vocoder_ckpt=f"{scratch}/vocoder/model",
        hubert_path=f"{scratch}/nonexistent_hubert", pe_ckpt="",
        pe_enable=False, max_frames=42000, max_input_tokens=60000,
        mel_vmin=-6.0, mel_vmax=1.5, num_spk=1,
        binarization_args=dict(with_f0=True, with_hubert=True,
                               with_align=True),
        work_dir=f"{scratch}/work", pndm_speedup=20, debug=False,
        raw_data_dir=f"{scratch}/raw", binary_data_dir=f"{scratch}/binary",
        speaker_id="demo", binarizer_cls="preprocessing.SVCpre.SVCBinarizer",
        task_cls="training.task.SVC_task.SVCTask",
        max_sentences=8, max_tokens=100000,
        max_updates=300, val_check_interval=100,
        num_sanity_val_steps=1, num_valid_plots=1, num_ckpt_keep=3,
        lr=8e-4, scheduler="step_lr", decay_steps=50000,
        optimizer_adam_beta1=0.9, optimizer_adam_beta2=0.98, weight_decay=0,
        clip_grad_norm=1, accumulate_grad_batches=1, seed=1234,
        save_ckpt=True, endless_ds=True, ds_workers=0, test_num=2,
        valid_num=0, train_set_name="train", valid_set_name="valid",
        test_set_name="test", **p["dims"])
    hp.update(overrides)
    return hp


def device_info(device) -> dict:
    """The device's name and, on the card, ``nvidia-smi``'s name and power
    limit (every number a tool writes is read beside them)."""
    import torch

    if device.type != "cuda":
        return {"device": "cpu", "backend": "cpu", "card": None}
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return {"device": torch.cuda.get_device_name(device),
            "backend": "cuda", "card": out.stdout.strip().splitlines()[0]}


def kernels_ready(device) -> float:
    """Build (or load) the kernel library before anything is timed; its
    seconds (0 on the CPU)."""
    if device.type != "cuda":
        return 0.0
    from ..ops.hopper import _build

    t0 = time.time()
    _build.lib()
    return time.time() - t0


def launches() -> dict:
    """K2-K5's counters: K2's ladders, K3's tails, K4's backward calls (one
    per step on the batched route) and K5's (the per-sample route)."""
    from ..ops.hopper import (diffnet_stack_per_sample, diffnet_stack_train,
                              plms_ladder, vocoder_tail)

    return {"K2": plms_ladder.launches, "K3": vocoder_tail.launches,
            "K4": diffnet_stack_train.bwd_launches,
            "K5": diffnet_stack_per_sample.launches}


def since(before: dict) -> dict:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {k: v - before[k] for k, v in launches().items()}


class RecordingWriter:
    """A SummaryWriter's interface that records scalars, figures and audio
    for the summary, and forwards them to TensorBoard where it imports."""

    def __init__(self, logdir: str):
        self.scalars, self.artifacts, self.audio = {}, [], []
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self.tb = None
        else:
            self.tb = SummaryWriter(logdir)

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((int(step), float(value)))
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)

    def add_figure(self, tag, fig, step):
        self.artifacts.append(("figure", tag, int(step)))
        if self.tb is not None:
            self.tb.add_figure(tag, fig, step)

    def add_audio(self, tag, wav, step, sr):
        self.artifacts.append(("audio", tag, int(step)))
        w = np.asarray(wav, np.float64).reshape(-1)
        self.audio.append({"tag": tag, "step": int(step), "samples": w.size,
                           "seconds": w.size / float(sr),
                           "rms": float(np.sqrt(np.mean(w ** 2))),
                           "finite": bool(np.isfinite(w).all())})
        if self.tb is not None:
            self.tb.add_audio(tag, wav, step, sr)

    def flush(self):
        if self.tb is not None:
            self.tb.flush()

    def close(self):
        if self.tb is not None:
            self.tb.close()


def train_route(hp) -> dict:
    """The route ``diffnet.train_route`` gives the largest train batch
    (``max_sentences`` of the longest item, padded to ``frames_multiple``)."""
    from ..data.dataset import FastSpeechDataset
    from ..models import diffnet

    sizes = FastSpeechDataset("train", hp).sizes
    frames = int(max(sizes))
    mult = int(hp.get("frames_multiple", 128))
    t_pad = -(-frames // mult) * mult
    b = min(int(hp["max_sentences"]), len(sizes))
    stream = str(hp.get("diffnet_train_stream_dtype", "bf16"))
    return {"batch": f"{b} x {frames} frames (padded to {t_pad})",
            "route": diffnet.train_route(
                int(hp["residual_layers"]), int(hp["dilation_cycle_length"]),
                t_pad, int(hp["residual_channels"]), b, stream,
                pallas=str(hp.get("diffnet_pallas_train", "auto"))),
            "stream": stream}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--resume-steps", type=int, default=100)
    ap.add_argument("--val-interval", type=int, default=100)
    ap.add_argument("--out", default=os.path.join(REPO, "runs/torch_train_demo"))
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths (8 kHz, 16 mel, DiffNet 32 x 4)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def run(args, scratch: str) -> dict:
    """Build the data and the vocoder under ``scratch``, binarize, fit,
    resume; returns the summary (``summary["hp"]``: the resolved hparams,
    whose ``work_dir`` holds the checkpoints).  Raises without a card
    unless the CPU was asked for."""
    from ..infer.svc import default_device

    device = default_device(args.device)
    import yaml

    from ..config.hparams import set_hparams
    from ..data.binarizer import binarize
    from ..training.trainer import Trainer
    from ..utils import synth

    info = device_info(device)
    log(f"| device: {info['device']} ({info['card']})")
    p = profile(args.tiny)
    log("| building dataset + vocoder ckpt ...")
    synth.make_dataset(f"{scratch}/raw", sr=p["sr"], dur=p["dur"])
    synth.write_nsf_generator(f"{scratch}/vocoder", p["vocoder"], seed=0)
    hp_dict = tool_hp(scratch, p, max_updates=args.steps,
                      val_check_interval=args.val_interval)
    cfg_path = f"{scratch}/config.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(hp_dict, f)

    log("| binarizing ...")
    hp = set_hparams(config=cfg_path, exp_name="torch_demo", reset=True,
                     print_hparams=False)
    binarize(hp, device=device)
    route = train_route(hp)
    log(f"| train batch {route['batch']}: route {route['route']}")

    writer = RecordingWriter(f"{scratch}/work/tb")
    counts = launches()
    trainer = Trainer(hp, log_writer=writer, device=device)
    log(f"| training {args.steps} steps on {info['device']} ...")
    t0 = time.time()
    trainer.fit()
    wall1 = time.time() - t0
    step1 = trainer.global_step
    launches1 = since(counts)
    log(f"| phase 1 done: step={step1} wall={wall1:.1f}s launches {launches1}")

    # resume: a fresh Trainer must pick up the latest checkpoint
    hp["max_updates"] = args.steps + args.resume_steps
    counts = launches()
    trainer2 = Trainer(hp, log_writer=writer, device=device)
    trainer2.restore()      # the step it picks up (fit restores it again)
    resumed_from = trainer2.global_step
    t0 = time.time()
    trainer2.fit()
    wall2 = time.time() - t0
    step2 = trainer2.global_step
    launches2 = since(counts)
    ckpts = sorted(glob.glob(f"{hp['work_dir']}/model_ckpt_steps_*.ckpt"))
    log(f"| resume done: step={step2} wall={wall2:.1f}s launches {launches2}")
    writer.close()

    tr_loss = writer.scalars.get("tr/loss", [])
    val_loss = writer.scalars.get("val/loss", [])
    return {
        **info,
        "dims": (f"{p['label']}: {p['nmel']} mel, "
                 f"{hp['residual_channels']}ch x {hp['residual_layers']} "
                 f"layers, K={hp['K_step']}"),
        "batch": route["batch"],
        "train_route": route["route"],
        "train_stream_dtype": route["stream"],
        "phase1": {"steps": step1, "wall_s": round(wall1, 1),
                   "launches": launches1},
        "resume": {"from_step": resumed_from, "to_step": step2,
                   "wall_s": round(wall2, 1),
                   "steps_per_s": round(args.resume_steps / wall2, 2),
                   "launches": launches2},
        "checkpoints": [os.path.basename(c) for c in ckpts],
        "scalar_tags": sorted(writer.scalars),
        "tr_loss_curve": tr_loss,
        "val_loss_curve": val_loss,
        "tb_artifacts": writer.artifacts,
        "validation_wav": writer.audio[-1] if writer.audio else None,
        "hp": hp,
    }


def loss_ends(summary: dict):
    """(first, last) of the validation loss curve (the training curve when
    no validation was logged)."""
    curve = summary["val_loss_curve"] or summary["tr_loss_curve"]
    if not curve:
        return float("nan"), float("nan")
    return curve[0][1], curve[-1][1]


def report(args, summary: dict, scratch: str) -> None:
    """Write ``summary.json`` and ``config.yaml`` under ``--out``, check the
    JAX tool's asserts and print the JSON line."""
    os.makedirs(args.out, exist_ok=True)
    shutil.copy(os.path.join(scratch, "config.yaml"),
                os.path.join(args.out, "config.yaml"))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({k: v for k, v in summary.items() if k != "hp"}, f,
                  indent=1)
    first, last = loss_ends(summary)
    log(f"| loss first {first:.4f} -> last {last:.4f}")
    got = (summary["resume"]["from_step"], summary["resume"]["to_step"])
    want = (args.steps, args.steps + args.resume_steps)
    if got != want:
        raise RuntimeError(f"resumed from and to steps {got}, not {want}")
    if args.steps >= 50 and not last < first:
        raise RuntimeError(f"validation loss did not decrease ({first} -> "
                           f"{last})")
    print(json.dumps({"metric": "torch_train_demo",
                      "steps": summary["resume"]["to_step"],
                      "loss_first": round(float(first), 4),
                      "loss_last": round(float(last), 4),
                      "steps_per_s": summary["resume"]["steps_per_s"],
                      "card": summary["card"]}))
    log(f"| summary written to {args.out}/summary.json")


def main(argv=None) -> dict:
    args = parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="torch_train_demo_") as scratch:
        with contextlib.redirect_stdout(sys.stderr):
            summary = run(args, scratch)
        report(args, summary, scratch)
    return summary


if __name__ == "__main__":
    main()
