"""Per-utterance feature pipeline: file -> processed item -> sample -> batch.

Counterpart of ``diffsvc_tpu/data/features.py`` (reference
``preprocessing/process_pipeline.py`` / ``infer_tool.py``): wav2spec through
the vocoder, CREPE or the AC f0 tracker, the uniform ``get_align`` stretch,
the binarizer's ``process_item`` (with the optional MFA TextGrid
alignment) and its batched ``process_items_batched``, the f0 track cache
(``f0_cache_dir``), ``getitem`` and the pad-to-longest collate.  Host-side
numpy except the mel, the f0 trackers and the content encoder, which run
on the given device.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import f0_ac
from ..ops.f0_ac import get_pitch_ac
from ..ops.pitch import f0_to_coarse_np, norm_interp_f0_np


def get_align_uniform(mel_len: int, n_units: int) -> np.ndarray:
    """Uniform stretch: 1-based unit ids per mel frame, 0 = padding
    (reference ``process_pipeline.py:95-107``, incl. its end_frame+1
    overlap)."""
    mel2ph = np.zeros([mel_len], int)
    ph_durs = mel_len / n_units
    start_frame = 0
    for i_ph in range(n_units):
        end_frame = int(i_ph * ph_durs + ph_durs + 0.5)
        mel2ph[start_frame: end_frame + 1] = i_ph + 1
        start_frame = end_frame + 1
    return mel2ph


def f0_cache_path(cache_dir: str, wav: np.ndarray, mel_len: int,
                  tag: str) -> str:
    """``{cache_dir}/{md5 of the wav's bytes}_{tag}_{mel_len}.npy``: the
    JAX package's name for the same track, so the two packages share a
    cache (the md5 is of the numpy array as given, the float32 wav that
    ``wav2spec_for`` returns)."""
    os.makedirs(cache_dir, exist_ok=True)
    md5 = hashlib.new("md5", np.ascontiguousarray(wav)).hexdigest()
    return os.path.join(cache_dir, f"{md5}_{tag}_{mel_len}.npy")


def get_pitch(wav: np.ndarray, mel: np.ndarray, hp, use_crepe: bool = False,
              threshold: float = 0.05, device="cpu",
              return_tag: bool = False):
    """(f0 [T_mel] f32, coarse [T_mel]), and with ``return_tag`` the
    tracker actually used ("crepe" or "ac"), as
    ``diffsvc_tpu/data/features.py:57-100``: CREPE when asked for, run on
    ``device`` (the caller's: the card under ``Svc``), falling back to the
    AC tracker only when CREPE's weights are missing (FileNotFoundError) or
    it cannot be imported; any other error raises.  Without CREPE, the AC
    tracker on ``device``.

    With ``f0_cache_dir`` set, a track cached under the requested tracker's
    tag (:func:`f0_cache_path`) is returned without tracking; otherwise the
    new track is saved under the tag of the tracker actually used (a CREPE
    fallback as ``ac``)."""
    cache_dir = hp.get("f0_cache_dir", "")
    if cache_dir:
        tag = "crepe" if use_crepe else "ac"
        fn = f0_cache_path(cache_dir, wav, len(mel), tag)
        if os.path.exists(fn):
            f0 = np.load(fn)
            coarse = f0_to_coarse_np(f0, hp["f0_bin"], float(hp["f0_min"]),
                                     float(hp["f0_max"]))
            return (f0, coarse, tag) if return_tag else (f0, coarse)
    tag = "ac"
    if use_crepe:
        try:
            from ..ops.crepe import get_pitch_crepe

            f0, coarse = get_pitch_crepe(wav, mel, hp, threshold,
                                         device=device)
            tag = "crepe"
        except (ImportError, FileNotFoundError) as e:
            print(f"| crepe unavailable ({e}); falling back to AC tracker")
    if tag == "ac":
        f0, coarse = get_pitch_ac(wav, len(mel), hp, device)
    if cache_dir:
        np.save(f0_cache_path(cache_dir, wav, len(mel), tag), f0)
    return (f0, coarse, tag) if return_tag else (f0, coarse)


def wav2spec_for(hp, wav_fn, device="cpu") -> tuple:
    """(wav, mel [T, M]) through the configured vocoder's wav2spec.  With
    ``wav_bucket_frames`` (default 128) the wav is zero-padded to a bucket
    multiple first and the mel (and the pwg family's padded wav) trimmed
    to the true frame count, like the JAX package."""
    from ..utils.audio_io import load_wav, load_wav_nsf
    from ..vocoders.base import get_vocoder_cls

    cls = get_vocoder_cls(hp)
    bucket = int(hp.get("wav_bucket_frames", 128) or 1)
    if bucket <= 1:
        return cls.wav2spec(wav_fn, hp, device)
    is_nsf = "nsf" in str(hp["vocoder"]).lower()
    if isinstance(wav_fn, np.ndarray):
        wav = np.asarray(wav_fn, np.float32)
    elif is_nsf:
        wav, _ = load_wav_nsf(wav_fn, target_sr=hp["audio_sample_rate"])
    else:
        wav, _ = load_wav(wav_fn, sr=hp["audio_sample_rate"])
    hop, n_fft = hp["hop_size"], hp["fft_size"]
    if is_nsf:
        true_frames = 1 + (len(wav) + 2 * ((n_fft - hop) // 2) - n_fft) // hop
    else:
        true_frames = 1 + len(wav) // hop
    pad_len = -(-len(wav) // (bucket * hop)) * (bucket * hop)
    wav_out, mel = cls.wav2spec(np.pad(wav, (0, pad_len - len(wav))), hp,
                                device)
    return (wav if is_nsf else wav_out[: true_frames * hop]), \
        mel[:true_frames]


def process_item(item_name: str, wav_fn, hp, hubert_encode,
                 binarization_args: Optional[dict] = None, spk_id=None,
                 device="cpu", tg_fn=None, ph=None) -> Optional[Dict]:
    """One utterance -> the binarizer's item (mel, f0, pitch, hubert,
    mel2ph, spec_min/max) as ``diffsvc_tpu/data/features.py:147-192`` makes
    it: uniform mel2ph, CREPE (``use_crepe``) or the AC tracker,
    ``hubert_encode(wav_fn)`` units.  ``tg_fn`` / ``ph`` (an MFA TextGrid
    and its space-joined phonemes) give the forced-alignment ``mel2ph`` and
    ``dur`` instead (``data/textgrid.py``).  Returns None (and prints the
    message) when the item fails for any reason, e.g. an empty f0, as the
    binarizer skips it."""
    ba = binarization_args or hp.get("binarization_args", {})
    try:
        wav, mel = wav2spec_for(hp, wav_fn, device)
        processed = {
            "item_name": item_name, "mel": mel, "wav": wav,
            "sec": len(wav) / hp["audio_sample_rate"], "len": mel.shape[0],
            "spk_id": spk_id if spk_id is not None else hp.get("speaker_id", 0),
            "spec_min": np.min(mel, axis=0), "spec_max": np.max(mel, axis=0),
        }
        if ba.get("with_f0", True):
            f0, coarse = get_pitch(wav, mel, hp, hp.get("use_crepe", False),
                                   device=device)
            if f0.sum() == 0:
                raise ValueError("Empty **gt** f0")
            processed["f0"], processed["pitch"] = f0, coarse
        if ba.get("with_hubert", True):
            units = processed["hubert"] = hubert_encode(wav_fn)
            if ba.get("with_align", True):
                if tg_fn is not None and ph is not None:
                    from .textgrid import get_mel2ph

                    processed["mel2ph"], processed["dur"] = get_mel2ph(
                        tg_fn, ph, mel.shape[0], hp)
                else:
                    processed["mel2ph"] = get_align_uniform(mel.shape[0],
                                                            units.shape[0])
    except Exception as e:
        print(f"| Skip item ({e}). item_name: {item_name}")
        return None
    return processed


def process_items_batched(metas, hp, hubert_encode_batch,
                          binarization_args: Optional[dict] = None,
                          spk_ids=None, group_size: int = 8, device="cpu"):
    """Batched :func:`process_item` for the binarizer, as
    ``diffsvc_tpu/data/features.py:194-320``: items are grouped by their
    ``wav_bucket_frames * hop`` padded length, ``group_size`` at a time;
    per group ONE AC track of the padded waveforms on ``device``
    (``f0_ac.track`` over the batch, on the padded length's frame grid; the
    per-item tracker pads to the same length, so the tracks agree) cut onto
    each item's mel grid, and ONE ``hubert_encode_batch`` of their 16 kHz
    resamples (the host's ``audio_io.resample``, as JAX), each row trimmed
    to ``max(len * 16000 / sr // 320, 1)`` units; a sibling ``.npy`` of a
    wav wins.  The mel runs per item (``wav2spec_for``).  The units differ
    from the per-item encoder's (there the 16 kHz wav is padded to 0.4 s
    multiples; the attention sees other padding), as in JAX.

    ``metas``: (item_name, wav path) pairs;
    ``hubert_encode_batch(wavs16k [B, L]) -> units [B, T, 256]``.  Yields
    (index, item or None for a skipped item) in input order."""
    from ..utils.audio_io import load_wav, load_wav_nsf, resample

    ba = binarization_args or hp.get("binarization_args", {})
    is_nsf = "nsf" in str(hp.get("vocoder", "")).lower()
    hop = hp["hop_size"]
    bucket = int(hp.get("wav_bucket_frames", 128) or 1) * hop
    sr = hp["audio_sample_rate"]
    f0_min, f0_max = float(hp["f0_min"]), float(hp["f0_max"])
    done: Dict[int, Optional[Dict]] = {}
    next_idx = 0

    def ready():
        nonlocal next_idx
        while next_idx in done:
            yield next_idx, done.pop(next_idx)
            next_idx += 1

    groups: Dict[int, list] = {}
    for i, (item_name, wav_fn) in enumerate(metas):
        try:
            if is_nsf:
                wav, _ = load_wav_nsf(wav_fn, target_sr=sr)
            else:
                wav, _ = load_wav(wav_fn, sr=sr)
        except Exception as e:
            print(f"| Skip item ({e}). item_name: {item_name}")
            done[i] = None
            continue
        pad_len = -(-len(wav) // bucket) * bucket
        groups.setdefault(pad_len, []).append((i, item_name, wav_fn, wav))

    for pad_len, recs in groups.items():
        for start in range(0, len(recs), group_size):
            chunk = recs[start: start + group_size]
            wavs = np.stack([np.pad(r[3], (0, pad_len - len(r[3])))
                             for r in chunk])
            specs = [wav2spec_for(hp, r[3], device) for r in chunk]
            f0_tracks = f0_ac.track(
                torch.from_numpy(wavs).to(device), sr=sr, hop=hop,
                f0_min=f0_min, f0_max=f0_max).cpu().numpy()
            units_all = hubert_encode_batch(
                np.stack([resample(w, sr, 16000) for w in wavs]))
            for j, (i, item_name, wav_fn, wav) in enumerate(chunk):
                done[i] = _batched_item(
                    hp, ba, item_name, wav_fn, wav, specs[j], f0_tracks[j],
                    pad_len, units_all[j],
                    spk_ids[i] if spk_ids is not None
                    else hp.get("speaker_id", 0))
            yield from ready()
    yield from ready()


def _batched_item(hp, ba, item_name, wav_fn, wav, spec, f0_full, pad_len,
                  units, spk_id) -> Optional[Dict]:
    """One item of a batched group: the group's f0 track cut onto the
    item's mel grid (``features.py:283-290``'s pad arithmetic), its units
    trimmed (or its sibling ``.npy``), the uniform alignment."""
    hop, sr = hp["hop_size"], hp["audio_sample_rate"]
    try:
        wav_out, mel = spec
        processed = {
            "item_name": item_name, "wav": wav_out, "mel": mel,
            "sec": len(wav) / sr, "len": mel.shape[0], "spk_id": spk_id,
            "spec_min": np.min(mel, axis=0), "spec_max": np.max(mel, axis=0),
        }
        if ba.get("with_f0", True):
            pad_size = (pad_len // hop - len(f0_full) + 1) // 2
            mel_len = mel.shape[0]
            f0 = np.zeros(mel_len, np.float32)
            src0, dst0 = max(-pad_size, 0), max(pad_size, 0)
            n = min(len(f0_full) - src0, mel_len - dst0)
            if n > 0:
                f0[dst0: dst0 + n] = f0_full[src0: src0 + n]
            if f0.sum() == 0:
                raise ValueError("Empty **gt** f0")
            processed["f0"] = f0
            processed["pitch"] = f0_to_coarse_np(
                f0, hp["f0_bin"], float(hp["f0_min"]), float(hp["f0_max"]))
        if ba.get("with_hubert", True):
            npy_fn = Path(wav_fn).with_suffix(".npy") \
                if isinstance(wav_fn, (str, os.PathLike)) else None
            if npy_fn is not None and os.path.exists(npy_fn):
                processed["hubert"] = np.load(str(npy_fn))
            else:
                true_units = max(int(len(wav) * 16000 / sr) // 320, 1)
                processed["hubert"] = np.asarray(units[:true_units])
            if ba.get("with_align", True):
                processed["mel2ph"] = get_align_uniform(
                    mel.shape[0], processed["hubert"].shape[0])
    except Exception as e:
        print(f"| Skip item ({e}). item_name: {item_name}")
        return None
    return processed


def getitem(item: Dict, hp) -> Dict:
    """processed_input -> sample (max_frames clip, energy, norm_interp f0;
    ``fs2_utils.py:60-106``)."""
    max_frames = hp.get("max_frames", 42000)
    mel = np.asarray(item["mel"], np.float32)[:max_frames]
    energy = np.sqrt((np.exp(mel) ** 2).sum(-1))
    mel2ph = np.asarray(item["mel2ph"], np.int64)[:max_frames] \
        if "mel2ph" in item else None
    f0, uv = norm_interp_f0_np(np.asarray(item["f0"][:max_frames]),
                               pitch_norm=hp.get("pitch_norm", "log"),
                               use_uv=hp.get("use_uv", False),
                               f0_mean=float(hp.get("f0_mean", 0.0) or 0.0),
                               f0_std=float(hp.get("f0_std", 1.0) or 1.0))
    return {
        "id": item.get("id", 0),
        "item_name": item["item_name"],
        "hubert": np.asarray(item["hubert"], np.float32)[
            : hp.get("max_input_tokens", 60000)],
        "mel": mel,
        "pitch": np.asarray(item["pitch"], np.int64)[:max_frames],
        "energy": energy.astype(np.float32),
        "f0": f0,
        "uv": uv,
        "mel2ph": mel2ph,
        "spk_id": item.get("spk_id", 0),
    }


def collate_1d(values: List[np.ndarray], pad_value=0.0, max_len=None):
    size = max_len or max(v.shape[0] for v in values)
    res = np.full((len(values), size), pad_value, dtype=values[0].dtype)
    for i, v in enumerate(values):
        res[i, : len(v)] = v
    return res


def collate_2d(values: List[np.ndarray], pad_value=0.0, max_len=None):
    size = max_len or max(v.shape[0] for v in values)
    res = np.full((len(values), size, values[0].shape[1]), pad_value,
                  dtype=values[0].dtype)
    for i, v in enumerate(values):
        res[i, : len(v)] = v
    return res


def processed_input2batch(samples: List[Dict], hp=None,
                          pad_multiple: int = 1) -> Dict:
    """Pad-to-longest collate; ``pad_multiple`` rounds the padded lengths
    up (1 = the reference's exact behaviour)."""
    if not samples:
        return {}

    def _round(n):
        return -(-n // pad_multiple) * pad_multiple

    mel_max = _round(max(s["mel"].shape[0] for s in samples))
    hub_max = _round(max(s["hubert"].shape[0] for s in samples))
    batch = {
        "id": np.array([s["id"] for s in samples], np.int64),
        "item_name": [s["item_name"] for s in samples],
        "nsamples": len(samples),
        "hubert": collate_2d([s["hubert"] for s in samples], 0.0, hub_max),
        "mels": collate_2d([s["mel"] for s in samples], 0.0, mel_max),
        "mel_lengths": np.array([s["mel"].shape[0] for s in samples], np.int64),
        "mel2ph": collate_1d([s["mel2ph"] for s in samples], 0, mel_max)
        if samples[0]["mel2ph"] is not None else None,
        "energy": collate_1d([s["energy"] for s in samples], 0.0, mel_max),
        "pitch": collate_1d([s["pitch"] for s in samples], 0, mel_max),
        "f0": collate_1d([s["f0"] for s in samples], 0.0, mel_max),
        "uv": collate_1d([s["uv"] for s in samples], 0.0, mel_max),
    }
    if hp and hp.get("use_spk_id"):
        batch["spk_ids"] = np.array([s.get("spk_id", 0) for s in samples],
                                    np.int64)
    return batch
