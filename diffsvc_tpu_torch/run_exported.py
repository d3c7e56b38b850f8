"""Standalone consumer of the ``.pt2`` programs of ``infer/export.py``
(counterpart of ``tools/run_exported.py``).

A deployment needs ``torch`` and the port's op library
(``diffsvc_tpu_torch.ops.hopper``, which registers K1, K2 and K3) and none
of the port's model code to run the conversion chain (encoder -> sampler
-> vocoder) or a fused bucket.  Each program runs on the device its meta
records; a program exported on the card raises on a machine without one.

    python -m diffsvc_tpu_torch.run_exported --export_dir exported/myproj \\
        --features feats.npz --out out_dir

feats.npz keys (shapes from export_meta.json; pad/truncate to t_ph/t_mel):
    hubert [B, t_ph, hidden]   content units
    mel2ph [B, t_mel] int      1-based alignment (0 = padding)
    f0     [B, t_mel]          normalized log2 f0
    uv     [B, t_mel]          unvoiced mask (float)
    energy [B, t_mel]          (zeros if unused)
    noise  [B, t_mel, mel]     optional x_T; numpy's RandomState(--seed)
                               when absent

Writes mel.npy [B, t_mel, mel] (+ wav.npy when vocoder.pt2 exists).  With
``--fused``, ``--features`` is a raw wav (.npy, or .npz with a ``wav``
key) at the model's rate, converted by the smallest exported bucket that
holds it (``fused_{n}.pt2``), the draws made from
``torch.Generator().manual_seed(seed)`` at the shapes in
``fused_meta.json``; writes wav.npy, f0.npy and mel.npy.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .ops.hopper import load_program

SUFFIX = ".pt2"


def program_device(meta: dict) -> torch.device:
    """The device a program was exported on; raises when it is the card
    and there is none (no fallback to the CPU)."""
    dev = torch.device(meta.get("device", "cpu"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the programs were exported on a CUDA device and "
                           "run there; this machine has none (export again "
                           "with --device cpu to run on the CPU)")
    return dev


def run_fused(args) -> None:
    with open(os.path.join(args.export_dir, "fused_meta.json")) as f:
        meta = json.load(f)
    wav = np.load(args.features)
    if hasattr(wav, "files"):
        wav = wav["wav"]
    wav = np.asarray(wav, np.float32).ravel()
    buckets = sorted(int(k) for k in meta)
    n44 = next((b for b in buckets if b >= len(wav)), buckets[-1])
    if len(wav) > n44:
        print(f"| WARNING: input has {len(wav)} samples but the largest "
              f"exported bucket is {n44} — converting only the first "
              f"{n44} samples (export more buckets to cover longer audio)")
    bucket = meta[str(n44)]
    dev = program_device(bucket)
    wav_in = np.zeros((n44,), np.float32)
    wav_in[: min(len(wav), n44)] = wav[:n44]
    fused = load_program(os.path.join(args.export_dir,
                                      f"fused_{n44}{SUFFIX}"))
    gen = torch.Generator().manual_seed(int(args.seed))
    draw = {"normal": torch.randn, "uniform": torch.rand}
    draws = [draw[d["dist"]](d["shape"], generator=gen).to(dev)
             for d in bucket["draws"]]
    outs = fused(torch.from_numpy(wav_in).to(dev),
                 torch.tensor(float(args.key), device=dev),
                 torch.tensor(0, device=dev), *draws)
    os.makedirs(args.out, exist_ok=True)
    for name, arr in zip(("wav", "f0", "mel"), outs):
        np.save(os.path.join(args.out, f"{name}.npy"), arr.cpu().numpy())
    print(f"| fused bucket {n44}: wav {tuple(outs[0].shape)} "
          f"({bucket['sample_rate']} Hz) -> {args.out}/")


def run_chain(args) -> None:
    with open(os.path.join(args.export_dir, "export_meta.json")) as f:
        meta = json.load(f)
    dev = program_device(meta)
    feats = np.load(args.features)
    b, t_mel, t_ph = meta["batch"], meta["t_mel"], meta["t_ph"]

    def arr(name, dtype):
        return torch.from_numpy(np.asarray(feats[name], dtype)).to(dev)

    hubert = arr("hubert", np.float32)
    if tuple(hubert.shape) != (b, t_ph, meta["hidden"]):
        raise ValueError(f"hubert {tuple(hubert.shape)} != "
                         f"{(b, t_ph, meta['hidden'])}")
    mel2ph = arr("mel2ph", np.int64)
    encoder = load_program(os.path.join(args.export_dir, "encoder" + SUFFIX))
    sampler = load_program(os.path.join(args.export_dir, "sampler" + SUFFIX))
    cond, f0_denorm = encoder(hubert, mel2ph, arr("f0", np.float32),
                              arr("uv", np.float32),
                              arr("energy", np.float32))
    if "noise" in feats:
        noise = arr("noise", np.float32)
    else:
        noise = torch.from_numpy(np.random.RandomState(args.seed).randn(
            b, t_mel, meta["mel_bins"]).astype(np.float32)).to(dev)
    mel = sampler(cond, noise) * (mel2ph > 0)[:, :, None]
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "mel.npy"), mel.cpu().numpy())
    print(f"| mel: {tuple(mel.shape)} -> {args.out}/mel.npy")
    voc_path = os.path.join(args.export_dir, "vocoder" + SUFFIX)
    if os.path.exists(voc_path):
        wav = load_program(voc_path)(mel, f0_denorm)
        np.save(os.path.join(args.out, "wav.npy"), wav.cpu().numpy())
        print(f"| wav: {tuple(wav.shape)} ({meta['sample_rate']} Hz) "
              f"-> {args.out}/wav.npy")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--export_dir", required=True)
    ap.add_argument("--features", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fused", action="store_true",
                    help="consume a fused_{n}.pt2 program: --features is a "
                         "raw wav .npy/.npz")
    ap.add_argument("--key", type=float, default=0.0,
                    help="semitone shift (fused mode)")
    args = ap.parse_args(argv)
    with torch.no_grad():
        (run_fused if args.fused else run_chain)(args)


if __name__ == "__main__":
    main()
