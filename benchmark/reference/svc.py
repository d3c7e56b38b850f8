"""A whole song converted plainly: the slicer's chunks, and each voiced
chunk through the chain that ``run_clip(fused=True)`` runs (diff-svc's
``infer_tool.Svc.infer`` with the AC tracker and no pe), one chunk at a
time in f32, then the chunks concatenated and written as 16-bit PCM.

The chunk is zero-padded to the serving bucket (``fused_bucket_samples``,
hop x 256 by default) and trimmed back, as the program pads it; the
sampler's start noise and the NSF source's draws are redrawn in the
program's order from the seed the conversion was given.

``tails`` asks for the sampler and vocoder under several roundings at
once (``None``: the block's own; a dict: :func:`.precision.rounded`'s),
over one front end, and gives one output for each.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from . import dsp, nets, precision, slicer


def bucket_samples(hp: dict) -> int:
    return int(hp.get("fused_bucket_samples", 0) or int(hp["hop_size"]) * 256)


def geometry(hp: dict, voc: dict, n44: int) -> dict:
    hop, nfft = int(hp["hop_size"]), int(hp["fft_size"])
    t_mel = 1 + (n44 + 2 * ((nfft - hop) // 2) - nfft) // hop
    return dict(t_mel=t_mel, pad_t=-(-t_mel // 128) * 128,
                n_voc=t_mel * int(np.prod(voc["upsample_rates"])))


def draws(hp: dict, voc: dict, n44: int, seed: int, device):
    """(start noise [pad_t, M], the NSF source's U[0,1) phases [1, H+1] and
    unit noise [1, H+1, n_voc]) from a generator on ``device`` seeded with
    ``seed``, drawn in the program's order."""
    g = geometry(hp, voc, n44)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    h = int(voc["harmonic_num"]) + 1
    noise = torch.randn((1, g["pad_t"], int(hp["audio_num_mel_bins"])),
                        generator=gen, device=device)
    rand_ini = torch.rand((1, h), generator=gen, device=device)
    unit = torch.randn((1, h, g["n_voc"]), generator=gen, device=device)
    return noise[0], rand_ini, unit


def convert_chunk(w: dict, config: dict, wav: np.ndarray, key: float,
                  acc: int, seed: int, device, tails=(None,)) -> list:
    """One voiced chunk [n] at the model's rate -> a wav [n] float32 for
    each of ``tails``."""
    hp, voc = config["hparams"], config["vocoder"]
    sr, hop = int(hp["audio_sample_rate"]), int(hp["hop_size"])
    n = len(wav)
    bucket = bucket_samples(hp)
    n44 = -(-n // bucket) * bucket
    padded = np.zeros(n44, np.float32)
    padded[:n] = wav
    g = geometry(hp, voc, n44)
    t_mel, pad_t = g["t_mel"], g["pad_t"]
    noise, rand_ini, unit = draws(hp, voc, n44, seed, device)
    wav_t = torch.from_numpy(padded).to(device)
    wav16 = torch.from_numpy(dsp.resample(padded, sr, 16000)).to(device)
    f0_min, f0_max = float(hp["f0_min"]), float(hp["f0_max"])
    track = dsp.track_f0(wav_t, sr, hop, f0_min, f0_max)
    pad_size = (n44 // hop - len(track) + 1) // 2
    src, dst = max(-pad_size, 0), max(pad_size, 0)
    copy_n = min(len(track) - src, t_mel - dst)
    f0 = np.zeros(t_mel, np.float32)
    f0[dst: dst + copy_n] = track[src: src + copy_n]
    units = nets.hubert_units(w["hubert"], wav16, config["hubert"])
    mel2ph = np.zeros(pad_t, np.int64)
    mel2ph[:t_mel] = dsp.align_uniform(t_mel, units.shape[0])
    f0n, _ = dsp.norm_interp_f0(f0)
    f0n = f0n + np.float32(key / 12.0)
    f0n[f0n > math.log2(f0_max)] = 0.0
    f0n = np.pad(f0n, (0, pad_t - t_mel))
    mel2ph_t = torch.from_numpy(mel2ph).to(device)
    cond, f0_hz = nets.condition(w["diffusion"], hp, units[None],
                                 mel2ph_t[None],
                                 torch.from_numpy(f0n).to(device)[None])
    lo = float(np.asarray(hp["spec_min"]).ravel()[0])
    hi = float(np.asarray(hp["spec_max"]).ravel()[0])
    outs = []
    for kinds in tails:
        with (precision.rounded(kinds) if kinds is not None
              else contextlib.nullcontext()):
            x = nets.plms(w["diffusion"], hp, noise[None], cond, int(acc))[0]
            mel = ((x + 1.0) / 2.0 * (hi - lo) + lo) \
                * (mel2ph_t > 0)[:, None]
            mel = torch.clamp(mel[:t_mel], float(hp.get("mel_vmin", -6.0)),
                              float(hp.get("mel_vmax", 1.5)))
            har = nets.harmonic_source(w["generator"], voc, f0_hz[0, :t_mel],
                                       rand_ini, unit)
            y = nets.generator(w["generator"], voc, mel * dsp.LN_10, har)
        outs.append(y[:n].float().cpu().numpy())
    return outs


def convert_song(w: dict, config: dict, audio: np.ndarray, sr: int,
                 key: float, acc: int, seed: int, device,
                 slice_db: float = -40, tails=(None,)) -> list:
    """The song's output as the 16-bit samples the program writes, one
    for each of ``tails``."""
    chunks = slicer.cut(audio, sr, db_thresh=slice_db)
    outs = [[] for _ in tails]
    for v in chunks.values():
        a, b = map(int, v["split_time"].split(","))
        if v["slice"]:
            ys = [np.zeros(b - a, np.float32)] * len(tails)
        else:
            ys = convert_chunk(w, config, audio[a:b], key, acc, seed, device,
                               tails)
        for out, y in zip(outs, ys):
            out.append(y)
    return [(np.clip(np.concatenate(out) if out else np.zeros(0, np.float32),
                     -1.0, 1.0) * 32767).astype(np.int16) for out in outs]
