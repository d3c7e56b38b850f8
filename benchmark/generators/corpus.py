"""A binarized training corpus held in memory: the items the port's
binarizer writes for a voice (mel, f0, coarse pitch, HuBERT-soft units
and the uniform mel2ph alignment), for the port's batch producer to read.

The mix file fixes the items' lengths from its ``structure_seed`` (5-15 s
slices, the slicing diff-svc's docs recommend for training data), so every
run seed trains on the same set of shapes; the run's seed draws the
contents: a smooth log10-mel in the config's spec range, an f0 contour with
unvoiced stretches, unit vectors.
"""

from __future__ import annotations

import numpy as np


def lengths(mix: dict) -> np.ndarray:
    rng = np.random.default_rng(int(mix["structure_seed"]))
    lo, hi = mix["frames"]
    return rng.integers(int(lo), int(hi) + 1, int(mix["items"]))


def align_uniform(mel_len: int, n_units: int) -> np.ndarray:
    ph = mel_len / n_units
    end = np.floor(np.arange(n_units) * ph + ph + 0.5).astype(np.int64)
    return np.clip(np.searchsorted(end, np.arange(mel_len), side="left") + 1,
                   1, n_units)


def f0_to_coarse(f0, f0_bin=256, f0_min=50.0, f0_max=1100.0):
    lo = 1127.0 * np.log(1 + f0_min / 700.0)
    hi = 1127.0 * np.log(1 + f0_max / 700.0)
    m = 1127.0 * np.log(1 + np.asarray(f0) / 700.0)
    m = np.where(m > 0, (m - lo) * (f0_bin - 2) / (hi - lo) + 1, m)
    return np.rint(np.clip(m, 1, f0_bin - 1)).astype(np.int64)


def items(mix: dict, hp: dict, seed: int) -> list:
    """The corpus: one dict per item in the binarizer's layout."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 3])
    m, h = int(hp["audio_num_mel_bins"]), int(hp["hidden_size"])
    sr, hop = int(hp["audio_sample_rate"]), int(hp["hop_size"])
    lo = float(np.asarray(hp["spec_min"]).ravel()[0])
    hi = float(np.asarray(hp["spec_max"]).ravel()[0])
    out = []
    for i, t in enumerate(lengths(mix)):
        t = int(t)
        n_units = max(int(round(t * hop / sr * float(mix["unit_rate_hz"]))),
                      1)
        # a mel that drifts slowly in time and falls off with frequency
        base = np.linspace(hi - 0.5, lo + 0.5, m, dtype=np.float32)
        drift = np.cumsum(rng.standard_normal((t, 1), dtype=np.float32),
                          0) * np.float32(0.05)
        mel = np.clip(base[None] + drift + 0.3 * rng.standard_normal(
            (t, m), dtype=np.float32), lo, hi).astype(np.float32)
        f0 = rng.uniform(*mix["f0_hz"]) * 2 ** (0.1 * np.sin(
            np.arange(t) / rng.uniform(20, 80)))
        f0[rng.random(t) < float(mix["unvoiced_share"])] = 0.0
        out.append({
            "item_name": f"bench_{i}",
            "mel": mel,
            "f0": f0.astype(np.float32),
            "pitch": f0_to_coarse(f0, int(hp["f0_bin"]),
                                  float(hp["f0_min"]), float(hp["f0_max"])),
            "hubert": rng.standard_normal((n_units, h), dtype=np.float32),
            "mel2ph": align_uniform(t, n_units),
        })
    return out
