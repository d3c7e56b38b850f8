#!/usr/bin/env python3
"""Where the error of one hifigan GAN step's grads comes from, on the card.

    python3 tools/gan_step_error.py [--seeds 0 1 2] [--twins mel64 smooth]
        [--out FILE.json]

One ``VocoderTask`` step of the hifigan family at config_44k's
NSF-HiFiGAN width (upsample 512, rates 8, 8, 2, 2, 2, kernels 16, 16, 4,
4, 4, resblock 1 with kernels 3, 7, 11; MPD and MSD), as chip_smoke.py's
phase 11 takes it: B=2 crops of 32 frames at 44.1 kHz, here of synthetic
voiced clips (their NSF mel, a flat f0), per seed (init, clips and NSF
draws).  Three sets of grads are read, each against the same step in
float64 on the CPU:

- ``d``: D's grads (G's output with no gradient);
- ``g_same_d``: G's grads against the D from before the step;
- ``g_step``: G's grads against the D after its AdamW update, as the step
  takes them (what chip_smoke.py gates card against CPU).

The runs: ``card`` (TF32 off, as the smoke runs it), ``card_tf32`` (TF32
on for products and cuDNN: the lower-precision control) and ``cpu`` (the
CPU's f32 step); each again on a twin of the step (``--twins``):

- ``_mel64``: the mel term of G's loss (the log-mel of G's output and of
  the target) computed in float64 and the rest in float32 (the log-mel's
  grad is 1 / mel, so its quiet bins, near the clamp at 1e-5, multiply
  the f32 rounding of their STFT sums), against the plain reference;
- ``_smooth``: every leaky ReLU of G and D as ``s x + (1 - s)
  softplus(x, beta=50)``, against the reference of the same twin (an
  input within rounding of 0 can take the other branch in f32 than in
  f64, and a flipped slope passes 1 where the reference passes 0.1, or
  the reverse);

and ``card_vs_cpu`` (with each twin's suffix), the card's grads against
the CPU's, the smoke's reading.  A gap between ``g_same_d`` and ``g_step``
is what the D update adds: Adam's first update is about lr * sign(g), so a
D grad within rounding of 0 moves its weight by lr one way on one side and
the other way on the other.

Prints one line per run and seed, then one JSON line with every reading.
Runs on the card only (CUDA is required).
"""

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402  (its helpers; imports no torch)

SEG, B, SR = 32, 2, 44100


def crops(task, seed):
    """B voiced clips of SEG frames: the NSF mel of each (log10), the wav
    and a flat f0."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.utils import synth

    hop = int(task.hp["hop_size"])
    f0s = [150.0 + 40.0 * i + 10.0 * seed for i in range(B)]
    wav = np.stack([synth.voiced_wav(SEG * hop / SR + 0.1, SR, f0,
                                     seed=10 * seed + i)[: SEG * hop]
                    for i, f0 in enumerate(f0s)]).astype(np.float32)
    wav_t = torch.from_numpy(wav)
    mels = task.mel_for_loss(wav_t)[:, :SEG]
    f0 = torch.tensor(f0s)[:, None].expand(B, SEG).contiguous()
    return {"mels": mels, "wav": wav_t, "f0": f0}


def step_grads(hp, batch, draws, device, dtype, tf32=False, twin=""):
    """(D's grads, G's grads against the D before the step, G's grads
    against the updated D), each flattened to one float64 vector; ``twin``:
    ``mel64`` (the loss's mel in float64) or ``smooth`` (smooth leaky
    ReLUs)."""
    import torch

    from diffsvc_tpu_torch.models.nn import true_f32_convs
    from diffsvc_tpu_torch.training.vocoder_task import VocoderTask

    task = VocoderTask(hp, device=device)
    if twin == "mel64":
        mel = task.mel_for_loss
        task.mel_for_loss = lambda wav: mel(wav.double()).to(wav.dtype)
    task.gen.to(dtype)
    task.disc.to(dtype)
    b = {k: v.to(device, dtype) for k, v in batch.items()}
    dr = tuple(x.to(device, dtype) for x in draws)
    gp = list(task.gen.parameters())
    flat = lambda gs: torch.cat([g.detach().double().cpu().reshape(-1)
                                 for g in gs])
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    with contextlib.ExitStack() as stack:
        if twin == "smooth":
            stack.enter_context(smoke.smooth_leaky_relus())
        if tf32:
            for f in flags:
                stack.enter_context(smoke.swapped(f, allow_tf32=True))
        else:
            stack.enter_context(true_f32_convs())
        g_same = flat(torch.autograd.grad(task.g_loss(b, dr)[0], gp))
        with torch.no_grad():
            y_hat = task.gen_forward(b, dr)
        task._update(task.opt_d, task.disc, task.d_loss(b["wav"], y_hat))
        d = flat(p.grad for p in task.disc.parameters())
        g_step = flat(torch.autograd.grad(task.g_loss(b, dr)[0], gp))
    return {"d": d, "g_same_d": g_same, "g_step": g_step}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--twins", nargs="*", default=["mel64", "smooth"],
                    choices=["mel64", "smooth"])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.training.vocoder_task import VocoderTask

    if not torch.cuda.is_available():
        print("gan_step_error: CUDA is required", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": smoke.card_line(), "seeds": {}}
    print(out["card"], flush=True)
    twins = [""] + list(args.twins)
    variants = {f"{dev}{tf}{'_' if t else ''}{t}": (device, bool(tf), t)
                for dev, device in (("card", "cuda"), ("cpu", "cpu"))
                for tf in ("", "_tf32") if not (tf and dev == "cpu")
                for t in twins}
    for seed in args.seeds:
        # config_44k's sample rate, mel and STFT, the task's default
        # generator width (the NSF-HiFiGAN of config_44k)
        hp = HParams({"audio_sample_rate": SR, "audio_num_mel_bins": 128,
                      "fft_size": 2048, "hop_size": 512, "win_size": 2048,
                      "fmin": 40, "fmax": 16000, "vocoder": "nsf_hifigan",
                      "use_nsf": True, "vocoder_lr": 2e-4, "seed": seed})
        task = VocoderTask(hp, device="cpu")
        batch = crops(task, seed)
        draws = task.draw(batch, torch.Generator().manual_seed(100 + seed))
        del task
        # the twin mel64 is read against the plain reference (it changes
        # only the precision), smooth against a float64 reference of its own
        refs = {t: step_grads(hp, batch, draws, "cpu", torch.float64,
                              twin=t)
                for t in ("", "smooth") if t in twins}
        runs = {name: step_grads(hp, batch, draws, dev, torch.float32, tf,
                                 t)
                for name, (dev, tf, t) in variants.items()}
        res = {name: {k: smoke.rel_l2(v, refs["smooth" if t == "smooth"
                                              else ""][k])
                      for k, v in runs[name].items()}
               for name, (_, _, t) in variants.items()}
        for t in twins:
            sfx = f"_{t}" if t else ""
            res[f"card_vs_cpu{sfx}"] = {
                k: smoke.rel_l2(runs[f"card{sfx}"][k], runs[f"cpu{sfx}"][k])
                for k in refs[""]}
        for name, r in res.items():
            print(f"seed {seed} {name:17s}: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in r.items()),
                  flush=True)
        out["seeds"][seed] = res
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
