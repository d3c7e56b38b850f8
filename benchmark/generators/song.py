"""Synthetic sung songs: phrases of a vibrato voice with harmonics between
short near-silences, one song after another (a closed loop of one user).

The mix file fixes the pool's structure (how many songs, each song's
length, its phrases and gaps, their order) from its own
``structure_seed``, so every run seed converts the same sizes in the same
order; the run's seed draws the songs' notes, glides, vibrato, timbre,
noise and key.  The
voice is the port's ``utils/synth.voiced_wav`` recipe (a vibrato tone
with three harmonics and a noise floor) grown into phrases with notes,
glides and envelopes.
"""

from __future__ import annotations

import numpy as np


def plan(mix: dict) -> list:
    """The pool's structure: per song a list of (start_s, end_s) phrases
    and its total length, from the mix's ``structure_seed``."""
    p = mix["pool"]
    rng = np.random.default_rng(int(p["structure_seed"]))
    songs = []
    for _ in range(int(p["songs"])):
        total = float(rng.uniform(*p["song_s"]))
        t, phrases = float(p["lead_s"]), []
        while True:
            d = float(rng.uniform(*p["phrase_s"]))
            if t + d > total - float(p["lead_s"]):
                break
            phrases.append((t, t + d))
            t += d + float(rng.uniform(*p["gap_s"]))
        songs.append({"seconds": total, "phrases": phrases})
    return songs


def order(mix: dict) -> np.ndarray:
    """The order the songs are converted in, fixed with the pool's
    structure: every run seed offers the same work in the window."""
    return np.random.default_rng([int(mix["pool"]["structure_seed"]), 0]
                                 ).permutation(int(mix["pool"]["songs"]))


def render(mix: dict, song: dict, seed: int, index: int, sr: int,
           device="cpu"):
    """(int16 samples, key) of pool song ``index`` for run seed ``seed``:
    the per-phrase draws from numpy, the samples computed with torch on
    ``device`` (its noise from a generator there)."""
    import torch

    rng = np.random.default_rng([int(seed) % 2 ** 64, 1, int(index)])
    n = int(round(song["seconds"] * sr))
    g = torch.Generator(device=device).manual_seed(
        int(rng.integers(0, 2 ** 62)))
    wav = torch.randn(n, generator=g, device=device) * float(
        mix["noise_floor"])
    notes = np.asarray(mix["notes_hz"], np.float64)
    for a, b in song["phrases"]:
        i0, i1 = int(a * sr), min(int(b * sr), n)
        m = i1 - i0
        # a few notes per phrase, glided between
        k = int(rng.integers(2, 6))
        steps = notes[rng.integers(0, len(notes), k)]
        rate, depth = rng.uniform(4.5, 6.5), rng.uniform(0.01, 0.03)
        phase0 = rng.uniform(0, 6.28)
        amps = rng.uniform(0.6, 1.0, 3) * np.array([0.3, 0.1, 0.05])
        t = torch.arange(m, device=device, dtype=torch.float64) / sr
        centres = (torch.arange(k, device=device, dtype=torch.float64)
                   + 0.5) * (m / k) / sr
        pos = torch.clamp(torch.searchsorted(centres, t), 1, k - 1)
        lo, hi = centres[pos - 1], centres[pos]
        st = torch.as_tensor(steps, device=device)
        w = torch.clamp((t - lo) / (hi - lo), 0.0, 1.0)
        f_steps = st[pos - 1] * (1 - w) + st[pos] * w
        f0 = f_steps * (1.0 + depth * torch.sin(2 * np.pi * rate * t
                                                 + phase0))
        ph = torch.cumsum(f0 * (2 * np.pi / sr), 0)
        voice = (amps[0] * torch.sin(ph) + amps[1] * torch.sin(2 * ph)
                 + amps[2] * torch.sin(3 * ph))
        env = torch.clamp(torch.minimum(t, t[-1] - t) / 0.08, max=1.0)
        wav[i0:i1] += (voice * env).float()
    key = float(rng.choice(np.asarray(mix["keys"], np.float64)))
    pcm = (torch.clamp(wav, -1.0, 1.0) * 32767).to(torch.int16)
    return pcm.cpu().numpy(), key


def songs(mix: dict, seed: int, sr: int):
    """The run's songs in order: (pool index, seconds, structure) without
    their audio (render each with :func:`render`)."""
    pool = plan(mix)
    return [(int(i), pool[i]["seconds"], pool[i]) for i in order(mix)]
