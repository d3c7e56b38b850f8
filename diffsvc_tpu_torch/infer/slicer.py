"""Silence-based audio slicer (host-side I/O prep).

A copy of ``diffsvc_tpu/infer/slicer.py`` (that package's ``__init__``
imports JAX), without the optional native filters.

Parity target: reference ``infer_tools/slicer.py:41-156`` — windowed
max-amplitude dB vs threshold finds silent stretches; the exact cut point
inside each stretch is the RMS-window argmin refined by a short-window
amplitude argmin; ``min_length``/``max_silence_kept`` constraints; returns an
ordered chunk dict {slice: is_silence, split_time: "begin,end"}.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy.ndimage import maximum_filter1d, uniform_filter1d

from ..utils.audio_io import load_wav


def _window_maximum(arr: np.ndarray, win_sz: int) -> np.ndarray:
    return maximum_filter1d(arr, size=win_sz)[win_sz // 2: win_sz // 2 + arr.shape[0] - win_sz + 1]


def _window_rms(arr: np.ndarray, win_sz: int) -> np.ndarray:
    filtered = np.sqrt(np.abs(
        uniform_filter1d(np.power(arr, 2.0), win_sz)
        - np.power(uniform_filter1d(arr, win_sz), 2.0)))
    return filtered[win_sz // 2: win_sz // 2 + arr.shape[0] - win_sz + 1]


def level2db(levels, eps=1e-12):
    return 20 * np.log10(np.clip(levels, a_min=eps, a_max=1))


class Slicer:
    def __init__(self, sr: int, db_threshold: float = -40,
                 min_length: int = 5000, win_l: int = 300, win_s: int = 20,
                 max_silence_kept: int = 500):
        self.db_threshold = db_threshold
        self.min_samples = round(sr * min_length / 1000)
        self.win_ln = round(sr * win_l / 1000)
        self.win_sn = round(sr * win_s / 1000)
        self.max_silence = round(sr * max_silence_kept / 1000)
        if not self.min_samples >= self.win_ln >= self.win_sn:
            raise ValueError("min_length >= win_l >= win_s must hold")
        if not self.max_silence >= self.win_sn:
            raise ValueError("max_silence_kept >= win_s must hold")

    def slice(self, audio: np.ndarray) -> Dict[str, Dict]:
        # DELIBERATE TRANSCRIPTION FOR PARITY: this method follows the
        # reference's sequential scan (infer_tools/slicer.py:60-118)
        # step-for-step, keeping its variable roles (sil_tags, split-point
        # refinement, trailing-silence handling).  The cut points are part
        # of the product's compatibility surface — chunk caches are keyed
        # on them, and downstream concat assumes identical boundaries — so
        # they must match the reference bit-for-bit, including its
        # tie-breaking (argmin on equal minima) and its off-by-one window
        # conventions.  A restatement "in our own idiom" was considered and
        # rejected: any paraphrase of a stateful scan either reproduces the
        # same control flow under different names (no gain) or risks silent
        # boundary drift (real cost).  The surrounding DSP (windowed
        # max/RMS filters) IS re-implemented independently (C++/scipy
        # above); only the ~60-line cut-point scan is transcribed.
        samples = audio
        if samples.shape[0] <= self.min_samples:
            return {"0": {"slice": False, "split_time": f"0,{len(audio)}"}}
        abs_amp = np.abs(samples - np.mean(samples))
        win_max_db = level2db(_window_maximum(abs_amp, win_sz=self.win_ln))

        sil_tags: List[Tuple[int, int]] = []
        left = right = 0
        n = win_max_db.shape[0]
        while right < n:
            if win_max_db[right] < self.db_threshold:
                right += 1
            elif left == right:
                left += 1
                right += 1
            else:
                if left == 0:
                    split_loc_l = left
                else:
                    sil_left_n = min(self.max_silence, (right + self.win_ln - left) // 2)
                    rms_db_left = level2db(_window_rms(samples[left: left + sil_left_n], self.win_sn))
                    split_win_l = left + int(np.argmin(rms_db_left))
                    split_loc_l = split_win_l + int(np.argmin(abs_amp[split_win_l: split_win_l + self.win_sn]))
                if sil_tags and split_loc_l - sil_tags[-1][1] < self.min_samples and right < n - 1:
                    right += 1
                    left = right
                    continue
                if right == n - 1:
                    split_loc_r = right + self.win_ln
                else:
                    sil_right_n = min(self.max_silence, (right + self.win_ln - left) // 2)
                    rms_db_right = level2db(_window_rms(
                        samples[right + self.win_ln - sil_right_n: right + self.win_ln], self.win_sn))
                    split_win_r = right + self.win_ln - sil_right_n + int(np.argmin(rms_db_right))
                    split_loc_r = split_win_r + int(np.argmin(abs_amp[split_win_r: split_win_r + self.win_sn]))
                sil_tags.append((split_loc_l, split_loc_r))
                right += 1
                left = right
        if left != right:
            sil_left_n = min(self.max_silence, (right + self.win_ln - left) // 2)
            rms_db_left = level2db(_window_rms(samples[left: left + sil_left_n], self.win_sn))
            split_win_l = left + int(np.argmin(rms_db_left))
            split_loc_l = split_win_l + int(np.argmin(abs_amp[split_win_l: split_win_l + self.win_sn]))
            sil_tags.append((split_loc_l, samples.shape[0]))

        if not sil_tags:
            return {"0": {"slice": False, "split_time": f"0,{len(audio)}"}}
        chunks = []
        if sil_tags[0][0]:
            chunks.append({"slice": False, "split_time": f"0,{sil_tags[0][0]}"})
        for i in range(len(sil_tags)):
            if i:
                chunks.append({"slice": False,
                               "split_time": f"{sil_tags[i - 1][1]},{sil_tags[i][0]}"})
            chunks.append({"slice": True,
                           "split_time": f"{sil_tags[i][0]},{sil_tags[i][1]}"})
        if sil_tags[-1][1] != len(audio):
            chunks.append({"slice": False,
                           "split_time": f"{sil_tags[-1][1]},{len(audio)}"})
        return {str(i): c for i, c in enumerate(chunks)}


def cut(audio_path, db_thresh=-30, min_len=5000, win_l=300, win_s=20,
        max_sil_kept=500):
    audio, sr = load_wav(audio_path, mono=True)
    slicer = Slicer(sr=sr, db_threshold=db_thresh, min_length=min_len,
                    win_l=win_l, win_s=win_s, max_silence_kept=max_sil_kept)
    return slicer.slice(audio)


def chunks2audio(audio_path, chunks):
    chunks = dict(chunks)
    audio, sr = load_wav(audio_path, mono=True)
    result = []
    for k, v in chunks.items():
        tag = v["split_time"].split(",")
        result.append((v["slice"], audio[int(tag[0]): int(tag[1])]))
    return result, sr
