"""A whole song converted plainly by the batched route's chain
(``run_clip(batch_chunks=True)``): for each voiced chunk diff-svc's front
end (the pwg mel's frame grid on the wav padded to 128-frame buckets, the
AC tracker on the same buckets centred into that grid, HuBERT-soft on the 16 kHz
resample padded to 0.4 s, the uniform alignment, the f0 normalization),
chunks collated to 256 frames and grouped by padded length, then per group
the PLMS sampler, the pitch extractor pe on the sampled mel, and the
HiFi-GAN with its NSF source at pe's f0, in f32.  The draws (each group's
start noise, then its NSF source draws) are redrawn in the program's order
from the seed the conversion was given.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import dsp, nets, slicer
from .precision import conv1d, linear

PAD_MULTIPLE = 256        # Svc's collate padding
BUCKET_FRAMES = 128       # wav_bucket_frames


def front_end(w: dict, config: dict, wav: np.ndarray, key: float, device):
    """One chunk's collated sample: units [T_u, H], mel2ph [T] and f0
    (normalized, key-shifted) [T], each padded to 256, and the frames."""
    hp = config["hparams"]
    sr, hop = int(hp["audio_sample_rate"]), int(hp["hop_size"])
    bucket = BUCKET_FRAMES * hop
    true_frames = 1 + len(wav) // hop
    pad_len = -(-len(wav) // bucket) * bucket
    padded = np.pad(wav, (0, pad_len - len(wav))).astype(np.float32)
    # the pwg mel's frames of the padded wav (centred STFT)
    n_mel_frames = 1 + pad_len // hop
    # the wav the tracker reads: the padded wav to a hop multiple, cut to
    # the mel's frames
    l_pad = 0
    r_pad = (pad_len // hop + 1) * hop - pad_len
    wav_t = np.pad(padded, (l_pad, r_pad))[: n_mel_frames * hop]
    wav_t = wav_t[: true_frames * hop]
    pad2 = -(-len(wav_t) // bucket) * bucket
    wav_b = np.pad(wav_t, (0, pad2 - len(wav_t)))
    track = dsp.track_f0(torch.from_numpy(wav_b).to(device), sr, hop,
                         float(hp["f0_min"]), float(hp["f0_max"]))
    pad_size = (len(wav_b) // hop - len(track) + 1) // 2
    rpad = true_frames - len(track) - pad_size
    if rpad < 0:
        track = track[: len(track) + rpad]
        rpad = 0
    if pad_size < 0:
        track = track[-pad_size:]
        pad_size = 0
    f0 = np.pad(track, (pad_size, rpad))[:true_frames]
    wav16 = dsp.resample(wav, sr, 16000)
    n_units = max(len(wav16) // 320, 1)
    wav16 = np.pad(wav16, (0, -(-len(wav16) // 6400) * 6400 - len(wav16)))
    units = nets.hubert_units(w["hubert"], torch.from_numpy(wav16).to(device),
                              config["hubert"])[:n_units]
    mel2ph = dsp.align_uniform(true_frames, n_units)
    f0n, _ = dsp.norm_interp_f0(f0)
    t_pad = -(-true_frames // PAD_MULTIPLE) * PAD_MULTIPLE
    u_pad = -(-n_units // PAD_MULTIPLE) * PAD_MULTIPLE
    f0n = np.pad(f0n, (0, t_pad - true_frames)) + np.float32(key / 12.0)
    f0n[f0n > math.log2(float(hp["f0_max"]))] = 0.0
    return {"units": F.pad(units, (0, 0, 0, u_pad - n_units)),
            "mel2ph": np.pad(mel2ph, (0, t_pad - true_frames)),
            "f0": f0n.astype(np.float32), "frames": true_frames}


def pe_f0(sd: dict, hp: dict, mel: torch.Tensor) -> torch.Tensor:
    """diff-svc's pitch extractor on mel [B, T, M] -> f0 in Hz [B, T] (0 on
    all-zero padding frames)."""
    part = "pe"
    h = int(hp["hidden_size"])
    padding = mel.abs().sum(-1) == 0
    keep = (~padding).float()[:, None, :]
    x = mel.transpose(1, 2)
    for i in range(3):
        p = f"mel_prenet.layers.{i}"
        x = torch.relu(conv1d(x, sd[f"{p}.0.weight"], sd[f"{p}.0.bias"], part,
                              padding=2))
        x = ((x - sd[f"{p}.2.running_mean"][:, None])
             / torch.sqrt(sd[f"{p}.2.running_var"][:, None] + 1e-5)
             * sd[f"{p}.2.weight"][:, None] + sd[f"{p}.2.bias"][:, None])
        x = x * keep
    x = linear(x.transpose(1, 2), sd["mel_prenet.out_proj.weight"],
               sd["mel_prenet.out_proj.bias"], part) * keep.transpose(1, 2)
    x = linear(x, sd["mel_encoder.in_proj.weight"],
               sd["mel_encoder.in_proj.bias"], part)
    j = 0
    while f"mel_encoder.conv.{j}.conv.conv.weight" in sd:
        p = f"mel_encoder.conv.{j}"
        y = conv1d(x.transpose(1, 2), sd[f"{p}.conv.conv.weight"],
                   sd[f"{p}.conv.conv.bias"], part, padding=2)
        y = F.group_norm(y, h // 16, sd[f"{p}.norm.weight"],
                         sd[f"{p}.norm.bias"]).transpose(1, 2)
        x = x + torch.relu(y)
        j += 1
    x = linear(x, sd["mel_encoder.out_proj.weight"],
               sd["mel_encoder.out_proj.bias"], part)
    t = x.shape[1]
    half = h // 2
    emb = np.exp(np.arange(half, dtype=np.float64)
                 * -(math.log(10000.0) / (half - 1)))
    pos = np.arange(1, t + 1, dtype=np.float64)[:, None] * emb
    pos = torch.from_numpy(np.concatenate([np.sin(pos), np.cos(pos)], 1)
                           .astype(np.float32)).to(x.device)
    x = (x + sd["pitch_predictor.pos_embed_alpha"][0] * pos[None]
         ).transpose(1, 2)
    k = sd["pitch_predictor.conv.0.1.weight"].shape[-1]
    for i in range(5):
        p = f"pitch_predictor.conv.{i}"
        x = torch.relu(conv1d(F.pad(x, ((k - 1) // 2, (k - 1) // 2)),
                              sd[f"{p}.1.weight"], sd[f"{p}.1.bias"], part))
        x = F.layer_norm(x.transpose(1, 2), (x.shape[1],),
                         sd[f"{p}.3.weight"], sd[f"{p}.3.bias"]
                         ).transpose(1, 2)
    pred = linear(x.transpose(1, 2), sd["pitch_predictor.linear.weight"],
                  sd["pitch_predictor.linear.bias"], part)
    return torch.where(padding, torch.zeros_like(pred[..., 0]),
                       2.0 ** pred[..., 0])


def convert_chunks(w: dict, config: dict, chunks: list, key: float,
                   acc: int, seed: int, device, use_pe: bool = True) -> list:
    """The voiced chunks [n] -> their waves, grouped as the batched route
    groups them (equal padded mel and unit lengths, in order of first
    appearance), one sampling, pe and vocoder pass per group; without
    ``use_pe`` (or pe) the vocoder takes the conditioner's f0."""
    hp, voc = config["hparams"], config["vocoder"]
    samples = [front_end(w, config, c, key, device) for c in chunks]
    groups = {}
    for i, s in enumerate(samples):
        groups.setdefault((len(s["mel2ph"]), s["units"].shape[0]),
                          []).append(i)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    lo = float(np.asarray(hp["spec_min"]).ravel()[0])
    hi = float(np.asarray(hp["spec_max"]).ravel()[0])
    vmin, vmax = float(hp["mel_vmin"]), float(hp["mel_vmax"])
    up = int(np.prod(voc["upsample_rates"]))
    out = [None] * len(samples)
    for idxs in groups.values():
        units = torch.stack([samples[i]["units"] for i in idxs])
        mel2ph = torch.from_numpy(np.stack(
            [samples[i]["mel2ph"] for i in idxs])).to(device)
        f0n = torch.from_numpy(np.stack(
            [samples[i]["f0"] for i in idxs])).to(device)
        cond, f0_cond = nets.condition(w["diffusion"], hp, units, mel2ph,
                                       f0n)
        b, t_pad = mel2ph.shape
        x = torch.randn((b, t_pad, int(hp["audio_num_mel_bins"])),
                        generator=gen, device=device)
        x = nets.plms(w["diffusion"], hp, x, cond, int(acc))
        mel = ((x + 1.0) / 2.0 * (hi - lo) + lo) * (mel2ph > 0)[:, :, None]
        f0 = pe_f0(w["pe"], hp, mel) if use_pe and "pe" in w else f0_cond
        pad = (mel.abs().sum(-1) <= 0)[:, :, None]
        mel_v = torch.where(pad, torch.full_like(mel, vmin),
                            torch.clamp(mel, vmin, vmax))
        h = int(voc["harmonic_num"]) + 1
        rand_ini = torch.rand((b, h), generator=gen, device=device)
        unit = torch.randn((b, h, t_pad * up), generator=gen, device=device)
        for j, i in enumerate(idxs):
            har = nets.harmonic_source(w["generator"], voc, f0[j],
                                       rand_ini[j:j + 1], unit[j:j + 1])
            y = nets.generator(w["generator"], voc, mel_v[j], har)
            keep = int((mel[j].abs().sum(-1) > 0).sum())
            out[i] = y[: keep * up].float().cpu().numpy()
    return out


def convert_song(w: dict, config: dict, audio: np.ndarray, sr: int,
                 key: float, acc: int, seed: int, device,
                 slice_db: float = -40, use_pe: bool = True) -> np.ndarray:
    """The song's output as the 16-bit samples the program writes: each
    chunk's wave mean-filled to the chunk's length, as ``run_clip`` does.
    pe is used only at 24 kHz, as ``run_clip`` uses it."""
    use_pe = use_pe and int(config["hparams"]["audio_sample_rate"]) == 24000
    chunks = slicer.cut(audio, sr, db_thresh=slice_db)
    spans = [tuple(map(int, v["split_time"].split(","))) + (v["slice"],)
             for v in chunks.values()]
    voiced = [audio[a:b] for a, b, s in spans if not s]
    waves = iter(convert_chunks(w, config, voiced, key, acc, seed, device,
                                use_pe) if voiced else [])
    out = []
    for a, b, silent in spans:
        n = b - a
        if silent:
            out.append(np.zeros(n))
            continue
        y = next(waves)
        fix = np.full(n, np.mean(y) if len(y) else 0.0)
        fix[: len(y)] = y[0 if len(y) < n else len(y) - n:]
        out.append(fix)
    y = np.concatenate(out).astype(np.float32) if out else np.zeros(0)
    return (np.clip(y, -1.0, 1.0) * 32767).astype(np.int16)
