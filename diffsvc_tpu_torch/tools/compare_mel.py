"""mel-MCD / waveform comparison harness (the ``BASELINE.md`` parity
metric).

The port's counterpart of ``tools/compare_mel.py``: the same functions,
arguments, printout and exit code.  Compares two mel spectrograms (``.npy``,
[T, M], log10 domain) or two wavs:

    python -m diffsvc_tpu_torch.tools.compare_mel ref_mel.npy ours_mel.npy
    python -m diffsvc_tpu_torch.tools.compare_mel ref.wav ours.wav \\
        --config configs/config_44k.yaml [--device cpu]

MCD is the standard mel-cepstral distortion over the DCT coefficients of
the log-mel (10 sqrt(2) / ln(10) ||c1 - c2||), in dB, with the plain
log-mel L1 and RMSE beside it.  Exits 0 when the MCD is below 0.5 dB, else
1.  The ``.npy`` path is numpy and scipy only; the wav path reads the wavs
with the port's ``utils/audio_io`` and computes their mels with
``ops/mel.wav2spec`` on the card (``--device cpu`` asks for the CPU).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
from scipy.fftpack import dct

MCD_LIMIT_DB = 0.5      # BASELINE.md's target: mel-MCD below 0.5 dB


def align_lengths(a: np.ndarray, b: np.ndarray):
    n = min(len(a), len(b))
    return a[:n], b[:n]


def mel_mcd(mel1: np.ndarray, mel2: np.ndarray, n_coeffs: int = 13) -> float:
    """MCD (dB) between two log10-mel spectrograms [T, M]."""
    mel1, mel2 = align_lengths(mel1, mel2)
    # log10 -> ln for the cepstral convention
    c1 = dct(mel1 * np.log(10.0), type=2, axis=1, norm="ortho")[:, 1:n_coeffs]
    c2 = dct(mel2 * np.log(10.0), type=2, axis=1, norm="ortho")[:, 1:n_coeffs]
    k = 10.0 * np.sqrt(2.0) / np.log(10.0)
    return float(k * np.sqrt(((c1 - c2) ** 2).sum(axis=1)).mean())


def compare_mels(mel1, mel2) -> dict:
    mel1, mel2 = align_lengths(np.asarray(mel1), np.asarray(mel2))
    return {
        "mcd_db": mel_mcd(mel1, mel2),
        "l1": float(np.abs(mel1 - mel2).mean()),
        "rmse": float(np.sqrt(((mel1 - mel2) ** 2).mean())),
        "frames": int(len(mel1)),
    }


def wav_mels(ref: str, ours: str, config: str, device: str = "cuda"):
    """The two wavs' log10-mels [T, M] at the config's rate and geometry,
    computed on ``device`` (the card unless the CPU is asked for)."""
    from ..config import set_hparams
    from ..infer.svc import default_device
    from ..ops.mel import wav2spec
    from ..utils.audio_io import load_wav

    dev = default_device(device)
    hp = set_hparams(config, exp_name="", print_hparams=False, reset=True,
                     global_hparams=False)
    w1, _ = load_wav(ref, sr=hp["audio_sample_rate"])
    w2, _ = load_wav(ours, sr=hp["audio_sample_rate"])
    return wav2spec(w1, hp, dev)[1], wav2spec(w2, hp, dev)[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ref")
    ap.add_argument("ours")
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the wavs' mels are computed (default: the "
                    "card)")
    args = ap.parse_args(argv)

    if args.ref.endswith(".npy"):
        mel1, mel2 = np.load(args.ref), np.load(args.ours)
    else:
        if not args.config:
            ap.error("--config required for wav inputs")
        mel1, mel2 = wav_mels(args.ref, args.ours, args.config, args.device)

    stats = compare_mels(mel1, mel2)
    for k, v in stats.items():
        print(f"{k}: {v}")
    sys.exit(0 if stats["mcd_db"] < MCD_LIMIT_DB else 1)


if __name__ == "__main__":
    main()
