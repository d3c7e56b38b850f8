"""Per-utterance feature pipeline: file -> processed item -> sample -> batch.

Counterpart of ``diffsvc_tpu/data/features.py`` (reference
``preprocessing/process_pipeline.py`` / ``infer_tool.py``): wav2spec through
the vocoder, the AC f0 tracker, the uniform ``get_align`` stretch, the
binarizer's ``process_item``, ``getitem`` and the pad-to-longest collate.
Host-side numpy except the mel and the AC f0 tracker, which run on the
given device.  The JAX package's batched binarization pipeline is not
ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..ops.f0_ac import get_pitch_ac
from ..ops.pitch import norm_interp_f0_np


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


def get_pitch(wav: np.ndarray, mel: np.ndarray, hp, use_crepe: bool = False,
              device="cpu"):
    """(f0 [T_mel] f32, coarse [T_mel]) from the AC tracker, run on
    ``device`` (the caller's: the card under ``Svc``).  CREPE is not
    ported yet, so asking for it raises: the JAX package would run CREPE
    where its weights are installed, and a silent AC track would give other
    audio for the same flags."""
    if use_crepe:
        raise NotImplementedError("CREPE is not ported to torch yet; pass "
                                  "use_crepe=False (--no_crepe) for the AC "
                                  "tracker")
    return get_pitch_ac(wav, len(mel), hp, device)


def wav2spec_for(hp, wav_fn, device="cpu") -> tuple:
    """(wav, mel [T, M]) through the configured vocoder's wav2spec.  With
    ``wav_bucket_frames`` (default 128) the wav is zero-padded to a bucket
    multiple first and the mel trimmed to the true frame count, like the
    JAX package."""
    from ..utils.audio_io import load_wav_nsf
    from ..vocoders.base import get_vocoder_cls

    cls = get_vocoder_cls(hp)
    if "nsf" not in str(hp["vocoder"]).lower():
        raise NotImplementedError("only the NSF-HiFiGAN front end is ported")
    bucket = int(hp.get("wav_bucket_frames", 128) or 1)
    if bucket <= 1:
        return cls.wav2spec(wav_fn, hp, device)
    if isinstance(wav_fn, np.ndarray):
        wav = np.asarray(wav_fn, np.float32)
    else:
        wav, _ = load_wav_nsf(wav_fn, target_sr=hp["audio_sample_rate"])
    hop, n_fft = hp["hop_size"], hp["fft_size"]
    true_frames = 1 + (len(wav) + 2 * ((n_fft - hop) // 2) - n_fft) // hop
    pad_len = -(-len(wav) // (bucket * hop)) * (bucket * hop)
    _, mel = cls.wav2spec(np.pad(wav, (0, pad_len - len(wav))), hp, device)
    return wav, mel[:true_frames]


def process_item(item_name: str, wav_fn, hp, hubert_encode,
                 binarization_args: Optional[dict] = None, spk_id=None,
                 device="cpu") -> Optional[Dict]:
    """One utterance -> the binarizer's item (mel, f0, pitch, hubert,
    mel2ph, spec_min/max) as ``diffsvc_tpu/data/features.py:147-192`` makes
    it: uniform mel2ph, the AC tracker, ``hubert_encode(wav_fn)`` units.
    Returns None (and prints) when the item fails, e.g. an empty f0, as the
    binarizer skips it.  MFA TextGrid alignment is not ported."""
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
                processed["mel2ph"] = get_align_uniform(mel.shape[0],
                                                        units.shape[0])
    except (ValueError, OSError) as e:
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
