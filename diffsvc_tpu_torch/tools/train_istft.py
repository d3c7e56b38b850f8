"""Training demo of the iSTFT-head vocoder: the GAN + mel recipe of
``training/vocoder_task.py`` (MPD + MSD, feature matching, 45 x mel-L1)
at the production 44.1 kHz widths on the card, the held-out clip's mel-L1
before and after, and the trained weights saved with
``istft_head.save_params`` and read back through the ``IstftVocoder``
registry wrapper.

The port's counterpart of ``tools/train_istft_tpu.py``: the same
synthetic singing (:func:`make_clips`, harmonic voices with vibrato and
phrasing; f0 is the analytic curve on the mel frame grid), the same
hparams and widths, the same crop schedule (numpy ``RandomState(0)``) and
the same criterion (the held-out mel-L1 after training below 0.7 x the
one before).  No kernel of the port runs the iSTFT head, so K2-K5's
counters stay 0.

Writes ``<out>/summary.json`` (the JAX tool's keys, plus the card's name
and power limit, and the kernels' launches), ``before.wav``,
``after.wav``, ``target.wav`` and ``istft_g.npz``, and prints one JSON line
on stdout (every log goes to stderr).

    python -m diffsvc_tpu_torch.tools.train_istft [--steps 400]
        [--batch 8] [--segment-frames 32] [--out DIR] [--tiny]
        [--device cpu]

It runs on the card and raises without one; ``--device cpu`` asks for the
CPU.  ``--tiny`` selects the tiny widths (8 kHz, 16 mel, a 64 x 2 head),
not the device.
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

NOTES = [196.0, 220.0, 247.0, 262.0, 294.0, 330.0, 349.0, 392.0]


def profile(tiny: bool) -> dict:
    """Rate, STFT, mel and head widths, clip length and count
    (``tools/train_istft_tpu.py:89-94``)."""
    if tiny:
        return dict(sr=8000, hop=64, nfft=256, win=256, nmel=16, dim=64,
                    layers=2, dur=1.0, n_clips=4)
    return dict(sr=44100, hop=512, nfft=2048, win=2048, nmel=128, dim=512,
                layers=8, dur=2.0, n_clips=8)


def fmax_of(sr: int) -> float:
    return 16000.0 if sr > 16000 else 3500.0


def clip_features(wav: np.ndarray, sr, hop, n_mels, nfft, win, fmin, fmax,
                  device="cpu") -> np.ndarray:
    """The canonical NSF log10-mel [T, n_mels] of a clip (numpy)."""
    from ..ops import mel as mel_ops

    y = torch.as_tensor(np.asarray(wav, np.float32), device=device)
    return mel_ops.wav2mel_nsf(y, sr=sr, n_fft=nfft, hop=hop, win_length=win,
                               n_mels=n_mels, fmin=fmin,
                               fmax=fmax).cpu().numpy()


def make_clips(sr, n_clips, dur, hop, n_mels, nfft, win, fmin, fmax,
               device="cpu") -> list:
    """Synthetic singing + the NSF mel + analytic f0 on the mel grid
    (``tools/train_istft_tpu.py:34-62``, the same numpy draws)."""
    rng = np.random.RandomState(0)
    clips = []
    for i in range(n_clips):
        t = np.arange(int(sr * dur)) / sr
        f0c = NOTES[i % len(NOTES)] * 2 ** (
            0.04 * np.sin(2 * np.pi * (4.5 + 0.3 * i) * t)
            + 0.2 * np.sin(2 * np.pi * 0.4 * t + i))
        ph = np.cumsum(2 * np.pi * f0c / sr)
        wav = (0.35 * np.sin(ph) + 0.2 * np.sin(2 * ph)
               + 0.1 * np.sin(3 * ph) + 0.01 * rng.randn(len(t)))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * 0.8 * t + i)
        wav = (wav * env).astype(np.float32)
        mel = clip_features(wav, sr, hop, n_mels, nfft, win, fmin, fmax,
                            device)
        # analytic f0 at frame centres (zero where the phrasing env gates)
        centers = np.clip(np.arange(mel.shape[0]) * hop, 0, len(t) - 1)
        clips.append({"wav": wav, "mel": mel,
                      "f0": f0c[centers].astype(np.float32)})
    return clips


def nsf_randoms(task, n_frames: int, seed: int = 7):
    """The NSF source's draws of a held-out render at B=1, from a seeded
    generator on the task's device (the JAX tool's ``PRNGKey(7)``)."""
    from ..vocoders import generator as gen_mod

    g = torch.Generator(device=task.device).manual_seed(seed)
    return gen_mod.draw_randoms(
        1, n_frames * int(np.prod(task.cfg.upsample_rates)),
        task.cfg.harmonic_num, g, task.device)


def render(task, held: dict, randoms=None, stft: bool = True,
           serving=None):
    """The held-out clip rendered by the task's generator: (mel-L1 against
    its mel, the multi-resolution STFT loss against its wav (sc + mag; None
    without ``stft``), the wav [n] on the device).  The NSF generator takes
    ``serving`` (on the card :func:`generator.apply_serving`, its K3 tail)
    or, on the CPU, the plain ``apply``, on ln-mel and ``randoms``."""
    from ..models.nn import true_f32_convs
    from ..ops import mel as mel_ops
    from ..ops.stft_loss import multi_resolution_stft_loss
    from ..vocoders import generator as gen_mod
    from ..vocoders import istft_head

    dev = task.device
    m = torch.as_tensor(held["mel"], dtype=torch.float32, device=dev)[None]
    f = torch.as_tensor(held["f0"], dtype=torch.float32, device=dev)[None]
    with torch.no_grad(), true_f32_convs():
        if task.family == "istft":
            y = istft_head.apply(task.gen, m, f)
        else:
            if serving is None:
                serving = gen_mod.apply_serving if dev.type == "cuda" \
                    else gen_mod.apply
            y = serving(task.gen, m * mel_ops.LN_10, f, randoms)
        mel_hat = task.mel_for_loss(y)
        n = min(mel_hat.shape[1], m.shape[1])
        l1 = float(torch.abs(mel_hat[:, :n] - m[:, :n]).mean())
        mr = None
        if stft:
            tgt = torch.as_tensor(held["wav"], device=dev)
            ln = min(y.shape[1], tgt.shape[0])
            sc, mag = multi_resolution_stft_loss(y[0, :ln], tgt[:ln])
            mr = float(sc + mag)
    return l1, mr, y[0]


def rounded(metrics: dict) -> dict:
    return {k: round(float(v), 4) for k, v in metrics.items()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--segment-frames", type=int, default=32)
    ap.add_argument("--log-interval", type=int, default=20)
    ap.add_argument("--out", default=None,
                    help="default runs/torch_istft_train (--tiny: "
                    "runs/torch_istft_train_tiny)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths (8 kHz, 16 mel, a 64 x 2 head)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = os.path.join(REPO, "runs", "torch_istft_train"
                                + ("_tiny" if args.tiny else ""))
    return args


def run(args) -> dict:
    """Train, score and reload; returns the summary (``ok``: the JAX
    tool's criterion).  Raises without a card unless the CPU was asked
    for."""
    from ..infer.svc import default_device

    device = default_device(args.device)
    from ..config import HParams
    from ..training.vocoder_task import VocoderTask, crop_batch
    from ..utils.audio_io import save_wav
    from ..vocoders import istft_head as ih

    info = device_info(device)
    log(f"| device: {info['device']} ({info['card']})")
    os.makedirs(args.out, exist_ok=True)
    p = profile(args.tiny)
    sr = p["sr"]
    hp = HParams(
        audio_sample_rate=sr, hop_size=p["hop"], fft_size=p["nfft"],
        win_size=p["win"], audio_num_mel_bins=p["nmel"], fmin=40,
        fmax=fmax_of(sr), vocoder="istftvocoder", use_nsf=True,
        istft_dim=p["dim"], istft_layers=p["layers"], vocoder_lr=2e-4,
        lambda_mel=45.0, seed=1234)
    clips = make_clips(sr, p["n_clips"], p["dur"], p["hop"], p["nmel"],
                       p["nfft"], p["win"], 40.0, fmax_of(sr), device)
    held_out, train_clips = clips[0], clips[1:]
    log(f"| clips: {len(train_clips)} train + 1 held-out, "
        f"{held_out['mel'].shape[0]} frames each")

    counts = launches()
    task = VocoderTask(hp, device=device)
    rng_np = np.random.RandomState(0)
    l1_before, _, wav_before = render(task, held_out, stft=False)
    log(f"| held-out mel L1 before training: {l1_before:.4f}")

    def step():
        picks = [train_clips[rng_np.randint(len(train_clips))]
                 for _ in range(args.batch)]
        batch = crop_batch(picks, hp, rng_np,
                           segment_frames=args.segment_frames)
        return task.train_step(batch)

    t0 = time.time()
    curve = [(1, rounded(step()))]          # float() waits for the step
    compile_s = time.time() - t0
    log(f"| first step: {compile_s:.1f}s")
    t0 = time.time()
    for s in range(2, args.steps + 1):
        metrics = step()
        if s % args.log_interval == 0 or s == args.steps:
            curve.append((s, rounded(metrics)))
            log(f"| step {s}: g_loss {curve[-1][1]['g_loss']:.3f} d_loss "
                f"{curve[-1][1]['d_loss']:.3f} mel "
                f"{curve[-1][1]['g_mel']:.4f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.time() - t0
    steps_s = (args.steps - 1) / max(train_s, 1e-9)
    log(f"| {args.steps - 1} steps in {train_s:.1f}s = {steps_s:.2f} steps/s")
    l1_after, _, wav_after = render(task, held_out, stft=False)
    log(f"| held-out mel L1 after: {l1_after:.4f} (before {l1_before:.4f})")

    # the checkpoint written and read back through the registry wrapper:
    # the params bit for bit, the render within the JAX tool's tolerance
    ckpt = os.path.join(args.out, "istft_g.npz")
    ih.save_params(ckpt, task.gen)
    wrapper = ih.IstftVocoder(HParams(dict(hp, vocoder_ckpt=ckpt)),
                              device=device)
    mine, theirs = task.gen.state_dict(), wrapper.gen.state_dict()
    params_exact = mine.keys() == theirs.keys() and all(
        torch.equal(mine[k].cpu(), theirs[k].cpu()) for k in mine)
    ref = wav_after.cpu().numpy()
    wav_wrap = wrapper.spec2wav(held_out["mel"], f0=held_out["f0"])
    render_max_diff = float(np.abs(wav_wrap - ref).max())
    render_rms = float(np.sqrt(np.mean(ref ** 2)))
    reload_ok = bool(params_exact
                     and render_max_diff < max(2e-2 * render_rms, 1e-5))
    log(f"| wrapper reload: params exact {params_exact}, render max|d| "
        f"{render_max_diff:.2e} (rms {render_rms:.3f}) -> ok {reload_ok}")
    used = since(counts)

    save_wav(wav_before.cpu().numpy(), os.path.join(args.out, "before.wav"),
             sr)
    save_wav(ref, os.path.join(args.out, "after.wav"), sr)
    save_wav(held_out["wav"], os.path.join(args.out, "target.wav"), sr)
    return {
        **info,
        "dims": {"sr": sr, "hop": p["hop"], "n_fft": p["nfft"],
                 "n_mels": p["nmel"], "dim": p["dim"], "layers": p["layers"],
                 "batch": args.batch, "segment_frames": args.segment_frames},
        "compile_s": round(compile_s, 1),
        "steps": args.steps,
        "steps_per_s": round(steps_s, 3),
        "ms_per_step": round(1000.0 / max(steps_s, 1e-9), 1),
        "loss_curve": [{"step": s, **m} for s, m in curve],
        "held_out_mel_l1": {"before": round(l1_before, 4),
                            "after": round(l1_after, 4)},
        "ckpt": ckpt,
        "wrapper_reload": {"ok": reload_ok, "params_exact": params_exact,
                           "render_max_abs_diff": render_max_diff,
                           "render_rms": render_rms},
        "launches": used,
        "ok": bool(l1_after < 0.7 * l1_before),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    with contextlib.redirect_stdout(sys.stderr):
        summary = run(args)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    log(f"| summary -> {args.out}/summary.json")
    g = [c["g_mel"] for c in summary["loss_curve"]]
    log(f"| train mel L1 first->last: {g[0]:.4f} -> {g[-1]:.4f}")
    print(json.dumps({"ok": summary["ok"],
                      "l1_before": summary["held_out_mel_l1"]["before"],
                      "l1_after": summary["held_out_mel_l1"]["after"],
                      "steps_per_s": summary["steps_per_s"],
                      "card": summary["card"]}))
    return summary


if __name__ == "__main__":
    main()
