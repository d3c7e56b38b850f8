"""NSF-HiFiGAN against the iSTFT head at the production widths: both
families trained with the same GAN + mel recipe (``training/
vocoder_task.py``: MPD + MSD, feature matching, 45 x mel-L1) on the same
clips, seeds and crop schedule, then the held-out clip scored with mel-L1
and the multi-resolution STFT loss before and after.

The port's counterpart of ``tools/ab_vocoder_tpu.py`` (the evidence behind
``config_44k_fast``'s vocoder choice): NSF at the openvpi defaults, the
head at 512 x 8, 16 clips of synthetic singing (``train_istft.make_clips``)
or of a recording (``--real-wav``: 2 s windows, the first held out; f0 from
the AC tracker).  On the card the NSF render runs K3
(``generator.apply_serving``, the serving tail; the JAX tool renders with
the plain ``gen.apply``), on the CPU the plain ``apply``; the NSF source's
draws come from a ``torch.Generator`` seeded with 7, on the device.

Writes ``<out>/summary.json`` (the JAX tool's keys, plus the card's name
and power limit and the kernels' launches over each family's renders),
``{nsf,istft}_{before,after}.wav``, ``target.wav`` and the trained
generators (``nsf_g.pt``, a state dict; ``istft_g.npz``, ``save_params``),
and prints one JSON line on stdout (every log goes to stderr).

    python -m diffsvc_tpu_torch.tools.ab_vocoder [--steps 1500]
        [--n-clips 16] [--real-wav WAV] [--out DIR] [--tiny] [--device cpu]

It runs on the card and raises without one; ``--device cpu`` asks for the
CPU.  ``--tiny`` selects the tiny widths (8 kHz, 16 mel, NSF 32 channels,
the head 64 x 2) and at most 4 steps and 4 clips, as the JAX tool's
``--cpu-smoke``.
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

from .train_demo import REPO, device_info, launches, log, since
from .train_istft import (clip_features, fmax_of, make_clips, nsf_randoms,
                          render, rounded)

TINY_NSF = dict(upsample_initial_channel=32, upsample_rates=[4, 4, 4],
                upsample_kernel_sizes=[8, 8, 8], resblock_kernel_sizes=[3],
                resblock_dilation_sizes=[[1, 3]])
RECIPE = ("shared VocoderTask GAN (MPD+MSD + FM + 45*mel-L1), same "
          "clips/seeds/crop schedule")


def profile(tiny: bool) -> dict:
    """Rates, widths and the two families' generator hparams
    (``tools/ab_vocoder_tpu.py:103-116``)."""
    if tiny:
        return dict(sr=8000, hop=64, nfft=256, win=256, nmel=16, dur=1.0,
                    istft=dict(istft_dim=64, istft_layers=2), nsf=TINY_NSF)
    return dict(sr=44100, hop=512, nfft=2048, win=2048, nmel=128, dur=2.0,
                istft=dict(istft_dim=512, istft_layers=8),
                nsf={})     # VocoderTask's openvpi defaults


def family_hp(p: dict, name: str):
    """The hparams of family ``name`` ("nsf" or "istft")."""
    from ..config import HParams

    voc = dict(vocoder="NsfHifiGAN", **p["nsf"]) if name == "nsf" \
        else dict(vocoder="istftvocoder", **p["istft"])
    return HParams(
        audio_sample_rate=p["sr"], hop_size=p["hop"], fft_size=p["nfft"],
        win_size=p["win"], audio_num_mel_bins=p["nmel"], fmin=40,
        fmax=fmax_of(p["sr"]), use_nsf=True, vocoder_lr=2e-4,
        lambda_mel=45.0, seed=1234, **voc)


def make_real_clips(path, sr, dur, hop, nmel, nfft, win, fmin, fmax,
                    device="cpu") -> list:
    """Clips of a recording in :func:`make_clips`' format
    (``tools/ab_vocoder_tpu.py:34-71``): the wav read (integers scaled by
    the type's max, channels averaged), resampled to ``sr`` and cut into
    non-overlapping ``dur``-second windows; the NSF mel and the AC
    tracker's f0 of each."""
    from scipy.io import wavfile

    from ..config import HParams
    from ..ops.f0_ac import get_pitch_ac
    from ..utils.audio_io import resample

    sr0, w = wavfile.read(path)
    if w.ndim > 1:
        w = w.mean(-1)
    if np.issubdtype(w.dtype, np.integer):
        w = w.astype(np.float32) / float(np.iinfo(w.dtype).max)
    if sr0 != sr:
        w = resample(w.astype(np.float32), sr0, sr)
    hp_f0 = HParams(audio_sample_rate=sr, hop_size=hop, f0_min=40.0,
                    f0_max=1100.0, f0_bin=256, wav_bucket_frames=1)
    n = int(sr * dur)
    clips = []
    for s in range(0, len(w) - n + 1, n):
        wav = np.asarray(w[s:s + n], np.float32)
        mel = clip_features(wav, sr, hop, nmel, nfft, win, fmin, fmax, device)
        f0, _ = get_pitch_ac(wav, mel.shape[0], hp_f0, device=device)
        clips.append({"wav": wav, "mel": mel,
                      "f0": np.asarray(f0, np.float32)})
    return clips


def scores(task, held: dict, randoms) -> tuple:
    """(mel-L1, mr-stft, wav [n] on the device) of the held-out render and
    the kernels' launches it made."""
    counts = launches()
    l1, mr, wav = render(task, held, randoms)
    return l1, mr, wav, since(counts)


def run_family(args, name: str, p: dict, held_out: dict, train_clips: list,
               device):
    """Train family ``name`` from its seed for ``args.steps`` steps on the
    shared crop schedule; returns (its result in the JAX tool's keys, the
    trained task)."""
    from ..training.vocoder_task import VocoderTask, crop_batch
    from ..utils.audio_io import save_wav

    hp = family_hp(p, name)
    task = VocoderTask(hp, device=device)
    randoms = nsf_randoms(task, held_out["mel"].shape[0]) \
        if task.family == "hifigan" else None
    l1_b, stft_b, wav_b, launch_b = scores(task, held_out, randoms)
    log(f"[{name}] held-out before: mel-L1 {l1_b:.4f} mr-stft {stft_b:.4f}")
    save_wav(wav_b.cpu().numpy(), f"{args.out}/{name}_before.wav", p["sr"])

    # the same crop schedule for both families: same seed, same picks
    rng_np = np.random.RandomState(0)
    curve = []
    t0 = time.time()
    for step in range(1, args.steps + 1):
        picks = [train_clips[rng_np.randint(len(train_clips))]
                 for _ in range(args.batch)]
        batch = crop_batch(picks, hp, rng_np,
                           segment_frames=args.segment_frames)
        metrics = task.train_step(batch)
        if step == 1:
            float(metrics["g_loss"])
            log(f"[{name}] first step: {time.time() - t0:.1f}s")
            t0 = time.time()
        if step % 100 == 0 or step == args.steps:
            curve.append({"step": step, **rounded(metrics)})
            log(f"[{name}] step {step}: g_mel {curve[-1]['g_mel']:.4f} d "
                f"{curve[-1]['d_loss']:.3f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    steps_s = (args.steps - 1) / max(time.time() - t0, 1e-9)
    l1_a, stft_a, wav_a, launch_a = scores(task, held_out, randoms)
    log(f"[{name}] held-out after {args.steps} steps: mel-L1 {l1_a:.4f} "
        f"mr-stft {stft_a:.4f} ({steps_s:.2f} steps/s)")
    save_wav(wav_a.cpu().numpy(), f"{args.out}/{name}_after.wav", p["sr"])
    # the trained generator, so renders are reproducible without training
    if task.family == "istft":
        from ..vocoders import istft_head

        istft_head.save_params(f"{args.out}/{name}_g.npz", task.gen)
    else:
        torch.save({k: v.cpu() for k, v in task.gen.state_dict().items()},
                   f"{args.out}/{name}_g.pt")
    return {
        "family": name, "steps": args.steps,
        "steps_per_s": round(steps_s, 3),
        "held_out": {"mel_l1_before": round(l1_b, 4),
                     "mel_l1_after": round(l1_a, 4),
                     "mr_stft_before": round(stft_b, 4),
                     "mr_stft_after": round(stft_a, 4)},
        "loss_curve": curve,
        "render_launches": {"before": launch_b, "after": launch_a},
    }, task


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--segment-frames", type=int, default=32)
    ap.add_argument("--n-clips", type=int, default=16)
    ap.add_argument("--real-wav", default=None,
                    help="train and score on a recording instead of "
                    "synthetic singing: 2 s windows, the first held out")
    ap.add_argument("--out", default=None,
                    help="default runs/torch_vocoder_ab (--tiny: "
                    "runs/torch_vocoder_ab_tiny)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths, at most 4 steps and 4 clips")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = os.path.join(REPO, "runs", "torch_vocoder_ab"
                                + ("_tiny" if args.tiny else ""))
    if args.tiny:
        args.steps = min(args.steps, 4)
        args.n_clips = min(args.n_clips, 4)
    return args


def run(args):
    """Both families; returns (the summary, {family: trained task}).
    Raises without a card unless the CPU was asked for."""
    from ..infer.svc import default_device

    device = default_device(args.device)
    from ..utils.audio_io import save_wav

    info = device_info(device)
    log(f"| device: {info['device']} ({info['card']})")
    os.makedirs(args.out, exist_ok=True)
    p = profile(args.tiny)
    feats = (p["sr"], p["dur"], p["hop"], p["nmel"], p["nfft"], p["win"],
             40.0, fmax_of(p["sr"]))
    if args.real_wav:
        # --n-clips caps the recording's windows too
        clips = make_real_clips(args.real_wav, *feats, device=device)
        clips = clips[: max(args.n_clips, 2)]
        log(f"| recording {args.real_wav}: {len(clips)} clips")
    else:
        sr, dur, hop, nmel, nfft, win, fmin, fmax = feats
        clips = make_clips(sr, args.n_clips, dur, hop, nmel, nfft, win, fmin,
                           fmax, device)
    held_out, train_clips = clips[0], clips[1:]
    log(f"| clips: {len(train_clips)} train + 1 held-out, "
        f"{held_out['mel'].shape[0]} frames each")
    results, tasks = {}, {}
    for name in ("nsf", "istft"):
        results[name], tasks[name] = run_family(args, name, p, held_out,
                                                train_clips, device)
    save_wav(held_out["wav"], f"{args.out}/target.wav", p["sr"])
    summary = {
        **info,
        "dims": {"sr": p["sr"], "hop": p["hop"], "n_fft": p["nfft"],
                 "n_mels": p["nmel"], "batch": args.batch,
                 "segment_frames": args.segment_frames,
                 "clips": args.n_clips, **p["istft"]},
        "recipe": RECIPE,
        "data": (f"real:{args.real_wav}" if args.real_wav
                 else "synthetic singing (make_clips)"),
        "results": results,
    }
    return summary, tasks


def main(argv=None) -> dict:
    args = parse_args(argv)
    with contextlib.redirect_stdout(sys.stderr):
        summary, _ = run(args)
    with open(f"{args.out}/summary.json", "w") as f:
        json.dump(summary, f, indent=1)
    log(f"| summary -> {args.out}/summary.json")
    print(json.dumps({"ab": {k: v["held_out"]
                             for k, v in summary["results"].items()},
                      "card": summary["card"]}))
    return summary


if __name__ == "__main__":
    main()
