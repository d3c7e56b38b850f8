"""diff-svc's silence slicer (``infer_tools/slicer.py``), frozen: the
windowed max / RMS in dB, the sequential cut-point scan, the chunk list.

A frozen copy of the port's ``diffsvc_tpu_torch/infer/slicer.py`` (itself
a transcription of the reference's scan, kept step for step so that the
cut points agree sample for sample)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy.ndimage import maximum_filter1d, uniform_filter1d

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


def cut(audio: np.ndarray, sr: int, db_thresh=-40, min_len=5000, win_l=300,
        win_s=20, max_sil_kept=500) -> Dict[str, Dict]:
    return Slicer(sr=sr, db_threshold=db_thresh, min_length=min_len,
                  win_l=win_l, win_s=win_s,
                  max_silence_kept=max_sil_kept).slice(audio)
