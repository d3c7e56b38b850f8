"""What the per-layer readers share: a kernel family's traced seconds, and
the shapes of the work a song cell's window ran, from the spans the song
entry records around each conversion call (``n``: the chunk's samples,
or ``ns``: each chunk's of a batched call)."""

from __future__ import annotations

import math


def kernel_seconds(run, pattern, family: str, worked: bool):
    """Device seconds of the traced kernels ``pattern`` finds; None where
    the run has no card trace.  A traced card run whose window did the
    family's work (``worked``) but whose trace holds none of its kernels
    fails: the kernels were renamed or replaced, and the reader has to
    learn the new names rather than leave its roofline out."""
    secs = sum(run.kernel_seconds(pattern).values())
    if secs:
        return secs
    if run.device == "cuda" and worked:
        raise RuntimeError(f"the window ran {family}'s work but the trace "
                           f"holds none of its kernels ({pattern.pattern})")
    return None


def _geometry(run, n44: int):
    hp = run.config["hparams"]
    hop, nfft = int(hp["hop_size"]), int(hp["fft_size"])
    if "nsf" in str(hp.get("vocoder", "")).lower():
        t_mel = 1 + (n44 + 2 * ((nfft - hop) // 2) - nfft) // hop
    else:
        t_mel = 1 + n44 // hop
    return t_mel, -(-t_mel // 128) * 128


def _bucket(run) -> int:
    hp = run.config["hparams"]
    return int(hp.get("fused_bucket_samples", 0) or int(hp["hop_size"]) * 256)


def chunk_samples(run) -> list:
    """Each converted voiced chunk's real samples."""
    out = []
    for w in run.work:
        out.extend(w["ns"] if "ns" in w else [w["n"]])
    return out


def ladder_shapes(run) -> list:
    """(B, padded frames) of each K2 call: a fused call pads its chunk to
    the bucket and the frames to 128; a batched call groups its chunks by
    padded length, one call per group."""
    out = []
    for w in run.work:
        if "ns" not in w:
            n44 = math.ceil(w["n"] / _bucket(run)) * _bucket(run)
            out.append((1, _geometry(run, n44)[1]))
        else:
            out.extend(batched_groups(run, w["ns"]))
    return out


def tail_shapes(run) -> list:
    """(B, frames) of each K3 call: a fused call vocodes its bucket's
    frames; a batched call a group's padded frames."""
    out = []
    for w in run.work:
        if "ns" not in w:
            n44 = math.ceil(w["n"] / _bucket(run)) * _bucket(run)
            out.append((1, _geometry(run, n44)[0]))
        else:
            out.extend(batched_groups(run, w["ns"]))
    return out


def batched_groups(run, ns) -> list:
    """(B, padded frames) per group of a batched call: ``Svc`` collates
    each chunk's mel (1 + n // hop frames) and units (one per 320 samples
    of the 16 kHz resample) to 256-multiples, and chunks of equal padded
    lengths share a group."""
    hp = run.config["hparams"]
    hop, sr = int(hp["hop_size"]), int(hp["audio_sample_rate"])
    groups = {}
    for n in ns:
        t = -(-(1 + n // hop) // 256) * 256
        units = max(-(-n * 16000 // sr) // 320, 1)
        key = (t, -(-units // 256) * 256)
        groups[key] = groups.get(key, 0) + 1
    return [(b, t) for (t, _), b in groups.items()]
