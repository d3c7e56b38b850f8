"""Praat long-format TextGrid parsing + forced-alignment ``mel2ph``.

A copy of ``diffsvc_tpu/data/textgrid.py`` (numpy only), so the port
imports nothing of the JAX package; ``tests/test_torch_standalone.py``
holds it against the original.

Behavior target: reference ``preprocessing/data_gen_utils.py:243-383``
(``TextGrid`` + ``get_mel2ph``).  Note that the reference's only caller is
explicitly disabled upstream (``base_binarizer.py:198-203`` returns before
the body, "isolated from other scripts"), so in both codebases this path
serves users who re-enable forced alignment for TTS-style corpora with
MFA TextGrids; SVC binarization always uses the uniform alignment
(:func:`diffsvc_tpu_torch.data.features.get_align_uniform`).

Differences from the reference, deliberate:
- empty lines are all skipped (the reference's ``remove_empty_lines``
  drops only the first empty line per call site);
- only ``IntervalTier`` is supported, like the reference, but unknown
  tier classes raise a clear error instead of ``NotImplementedError``
  mid-parse.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Tuple

import numpy as np


class Interval(NamedTuple):
    xmin: float
    xmax: float
    text: str


class Tier(NamedTuple):
    name: str
    xmin: float
    xmax: float
    intervals: List[Interval]


_SIL_TEXTS = {"sil", "sp", "", "SIL", "PUNC"}


def is_sil_phoneme(p: str) -> bool:
    """A phoneme token is silence-like iff it does not start with a letter
    (reference data_gen_utils.py:392-393: ``not p[0].isalpha()``)."""
    return not p[:1].isalpha()


class _Lines:
    """Cursor over the non-empty stripped lines of a TextGrid file."""

    def __init__(self, text: str):
        self.lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
        self.pos = 0

    def take(self, pattern: str) -> str:
        if self.pos >= len(self.lines):
            raise ValueError(f"TextGrid truncated; expected /{pattern}/")
        m = re.match(pattern, self.lines[self.pos])
        if m is None:
            raise ValueError(
                f"TextGrid format error at line {self.pos}: "
                f"{self.lines[self.pos]!r} (expected /{pattern}/)")
        self.pos += 1
        return m.group(1)

    def skip(self, n: int = 1):
        self.pos += n


def parse_textgrid(text: str) -> List[Tier]:
    """Parse a long-format ("text") TextGrid into its IntervalTiers."""
    c = _Lines(text)
    ftype = c.take(r'File type = "(.*)"')
    if "TextGrid" not in ftype and "ooTextFile" not in ftype:
        raise ValueError(f"not a TextGrid file (File type = {ftype!r})")
    c.skip()                                    # Object class
    c.take(r"xmin = (.*)")
    c.take(r"xmax = (.*)")
    c.skip()                                    # tiers? <exists>
    size = int(c.take(r"size = (.*)"))
    c.skip()                                    # item []:
    tiers: List[Tier] = []
    for _ in range(size):
        c.take(r"item \[(.*)\]:")
        klass = c.take(r'class = "(.*)"')
        if klass != "IntervalTier":
            raise ValueError(f"unsupported tier class {klass!r} "
                             "(only IntervalTier)")
        name = c.take(r'name = "(.*)"')
        xmin = float(c.take(r"xmin = (.*)"))
        xmax = float(c.take(r"xmax = (.*)"))
        n = int(c.take(r"intervals: size = (.*)"))
        items: List[Interval] = []
        for _ in range(n):
            c.take(r"intervals \[(.*)\]")
            i_min = float(c.take(r"xmin = (.*)"))
            i_max = float(c.take(r"xmax = (.*)"))
            i_txt = c.take(r'text = "(.*)"')
            items.append(Interval(i_min, i_max, i_txt))
        tiers.append(Tier(name, xmin, xmax, items))
    return tiers


def _merge_silences(intervals: List[Interval]) -> List[Interval]:
    """Canonicalize silence texts to '' and coalesce adjacent silences
    (reference get_mel2ph's tg_align_ pass)."""
    out: List[Interval] = []
    for iv in intervals:
        if iv.text in _SIL_TEXTS:
            if out and out[-1].text == "":
                out[-1] = out[-1]._replace(xmax=iv.xmax)
                continue
            iv = iv._replace(text="")
        out.append(iv)
    return out


def align_ph_to_intervals(ph_list: List[str],
                          intervals: List[Interval]) -> np.ndarray:
    """Phoneme split times (seconds) from aligned intervals.

    Returns ``split`` of length ``len(ph_list) + 1``: ``split[i]`` is the
    start time of phoneme i; ``split[-1]`` is an end sentinel.  Semantics
    follow reference get_mel2ph's two-pointer walk (data_gen_utils.py:
    345-372): silence intervals pair with silence-like phonemes, a
    silence phoneme with no silence interval collapses to zero length at
    the next real phoneme's start, trailing silence phonemes absorb the
    tail.
    """
    n_ph = len(ph_list)
    split = np.full(n_ph + 1, -1.0)
    END = 1e8

    tg_real = sum(1 for iv in intervals if iv.text != "")
    ph_real = sum(1 for p in ph_list if not is_sil_phoneme(p))
    if tg_real != ph_real:
        raise ValueError(
            f"TextGrid/phoneme mismatch: {tg_real} aligned vs "
            f"{ph_real} non-silence phonemes")

    ti = pi = 0
    while ti < len(intervals) or pi < n_ph:
        if ti == len(intervals):
            # intervals exhausted: only trailing silence phonemes remain
            if not is_sil_phoneme(ph_list[pi]):
                raise ValueError(f"phoneme {ph_list[pi]!r} beyond TextGrid")
            split[pi] = END
            pi += 1
            continue
        iv = intervals[ti]
        if pi == n_ph:
            if iv.text != "":
                raise ValueError(f"interval {iv.text!r} beyond phonemes")
            ti += 1                      # trailing silence interval
            continue
        ph = ph_list[pi]
        if iv.text == "" and not is_sil_phoneme(ph):
            raise ValueError(
                f"silence interval against non-silence phoneme {ph!r}")
        if iv.text != "" and is_sil_phoneme(ph):
            # silence phoneme with no matching silence interval:
            # zero-length, back-filled when the next real phoneme lands
            pi += 1
            continue
        # matched pair (sil-sil or text-text)
        if iv.text != "" and iv.text.lower() not in (ph.lower(), "sil"):
            raise ValueError(f"alignment text {iv.text!r} != phoneme {ph!r}")
        split[pi] = iv.xmin
        # back-fill EVERY pending zero-length silence phoneme (there can be
        # several in a row, e.g. "sp sil" when silences were merged away)
        j = pi - 1
        while j > 0 and split[j] == -1 and is_sil_phoneme(ph_list[j]):
            split[j] = split[pi]
            j -= 1
        pi += 1
        ti += 1
    split[0] = 0.0
    split[-1] = END
    bad = np.flatnonzero(split < 0)
    if bad.size:
        raise ValueError(f"unassigned phonemes at {bad.tolist()}")
    if (np.diff(split) < 0).any():
        raise ValueError("split times are not monotonic")
    return split


def get_mel2ph(tg_path: str, ph: str, mel_len: int,
               hp: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """Forced-alignment mel2ph + per-phoneme durations from a TextGrid.

    ``ph`` is the space-joined phoneme string; the LAST tier of the
    TextGrid carries the alignment (reference data_gen_utils.py:330).
    Returns ``(mel2ph [mel_len] int, dur [n_ph] int)`` with the
    reference's 1-based phoneme indexing (0 = padding).
    """
    ph_list = ph.split(" ")
    with open(tg_path, encoding="utf-8") as f:
        tiers = parse_textgrid(f.read())
    intervals = _merge_silences(tiers[-1].intervals)
    split = align_ph_to_intervals(ph_list, intervals)

    sr = float(hp["audio_sample_rate"])
    hop = float(hp["hop_size"])
    frames = np.asarray([int(s * sr / hop + 0.5) for s in split])
    mel2ph = np.zeros(mel_len, int)
    for i in range(len(ph_list)):
        mel2ph[frames[i]: frames[i + 1]] = i + 1
    dur = np.bincount(mel2ph, minlength=len(ph_list) + 1)[1:]
    return mel2ph, dur
