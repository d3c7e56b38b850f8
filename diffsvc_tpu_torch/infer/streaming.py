"""Click-free streaming conversion for DAW/VST buffers.

A copy of ``diffsvc_tpu/infer/streaming.py`` (that package's ``__init__``
imports JAX); ``tests/test_torch_standalone.py`` holds it against the
original.

Beyond-reference capability: the reference realtime service
(``flask_api.py:19-54``) converts every posted buffer independently, so
consecutive buffers meet with a timbre/phase discontinuity (an audible
click at each buffer boundary — a known weakness of the reference VST
workflow).  :class:`StreamingConverter` makes the stream continuous with
two standard tricks, at the cost of one constant ``crossfade_ms`` of
added latency:

- **left context**: each call converts ``[tail of previous input ++ new
  buffer]`` so the model sees real history instead of a zero boundary
  (the mel/f0/HuBERT analysis windows and the vocoder receptive field all
  straddle the seam).  Converter edge artifacts shorter than
  ``context_ms - crossfade_ms`` are discarded entirely — they land
  before the redo window;
- **held-tail crossfade**: the final ``crossfade_ms`` of every result is
  held back and, on the next call, blended (equal-gain raised cosine)
  with the re-rendering of the same time span — now computed with its
  true right context — before being emitted.

Timing contract: call k returns exactly ``len(buffer_k)`` samples except
the first call, which returns ``len(buffer_0) - C`` (the stream is
delayed by ``C = crossfade_ms`` samples); :meth:`flush` returns the final
held ``C`` samples.  Buffers shorter than one crossfade (common DAW/VST
block sizes of 256-1024 samples are below the 40 ms default) are
accumulated internally and return 0 samples until a full crossfade of
input is available — the emitted stream is delayed, never dropped.
Conversion is any ``f(np.float32[N]) -> [N]`` — the fused serving
graph, the modular path, or a test stub.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


class StreamingConverter:
    def __init__(self, convert_fn: Callable[[np.ndarray], np.ndarray],
                 sr: int, context_ms: float = 100.0,
                 crossfade_ms: float = 40.0):
        self.convert = convert_fn
        self.sr = int(sr)
        self.M = max(int(self.sr * context_ms / 1000.0), 1)
        self.C = max(int(self.sr * crossfade_ms / 1000.0), 1)
        if self.C > self.M:
            raise ValueError("crossfade_ms must be <= context_ms")
        t = (np.arange(self.C) + 0.5) / self.C
        # equal-GAIN ramp: the two sides are two renders of the SAME
        # audio (strongly correlated), where linear-sum blending is
        # correct; equal-power would bump the seam by up to +3 dB
        self._w = (0.5 - 0.5 * np.cos(np.pi * t)).astype(np.float32)
        self._in_tail: Optional[np.ndarray] = None
        self._held: Optional[np.ndarray] = None
        self._pending: Optional[np.ndarray] = None

    def __call__(self, buf: np.ndarray) -> np.ndarray:
        buf = np.asarray(buf, np.float32)
        if self._pending is not None:
            buf = np.concatenate([self._pending, buf])
            self._pending = None
        if len(buf) < self.C:
            # sub-crossfade buffer: accumulate until one crossfade length
            # of input is available (small DAW/VST block sizes)
            self._pending = buf
            return np.zeros(0, np.float32)
        if self._in_tail is None:
            y = np.asarray(self.convert(buf), np.float32)
            out = y[: len(buf) - self.C]
            self._held = y[len(buf) - self.C: len(buf)].copy()
            self._in_tail = buf[-self.M:].copy()
            return out
        x = np.concatenate([self._in_tail, buf])
        mi = len(self._in_tail)
        y = np.asarray(self.convert(x), np.float32)
        redo = y[mi - self.C: mi]              # held span, with context
        # h + w*(redo-h) rather than (1-w)*h + w*redo: bit-exact (== h ==
        # redo) when the two renders agree, e.g. a stateless converter
        blended = self._held + self._w * (redo - self._held)
        out = np.concatenate([blended, y[mi: len(x) - self.C]])
        self._held = y[len(x) - self.C: len(x)].copy()
        self._in_tail = x[-self.M:].copy()
        return out

    def flush(self) -> np.ndarray:
        """Emit any accumulated sub-crossfade input plus the held tail,
        then reset the stream."""
        pending = self._pending
        self._pending = None
        if pending is not None and len(pending):
            if self._in_tail is None:
                # stream was only ever sub-crossfade input: convert as-is
                y = np.asarray(self.convert(pending), np.float32)
                self._held = None
                return y
            x = np.concatenate([self._in_tail, pending])
            mi = len(self._in_tail)
            y = np.asarray(self.convert(x), np.float32)
            redo = y[mi - self.C: mi]
            blended = self._held + self._w * (redo - self._held)
            self._in_tail = None
            self._held = None
            return np.concatenate([blended, y[mi:]])
        held = (self._held if self._held is not None
                else np.zeros(0, np.float32))
        self._in_tail = None
        self._held = None
        return held


def boundary_jump(chunks) -> float:
    """Largest sample-to-sample step across chunk boundaries — the click
    metric the crossfade is meant to minimize."""
    jumps = [abs(float(b[0]) - float(a[-1]))
             for a, b in zip(chunks[:-1], chunks[1:]) if len(a) and len(b)]
    return max(jumps) if jumps else 0.0
