"""PQMF: the pseudo-quadrature mirror filterbank of multi-band vocoders.

Counterpart of ``diffsvc_tpu/vocoders/pqmf.py:15-69`` (reference
``modules/parallel_wavegan/layers/pqmf.py``): N-band analysis and
synthesis with a Kaiser-windowed prototype lowpass (62 taps, cutoff
0.15, beta 9 for 4 bands), the cosine modulation centred at
(taps - 1) / 2 as the reference's is.  The filters are buffers under the
official names (``analysis_filter`` [S, 1, taps+1], ``synthesis_filter``
[1, S, taps+1]).  Subband signals are [B, T // S, S], as the JAX
package's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def design_prototype_filter(taps: int = 62, cutoff_ratio: float = 0.15,
                            beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc prototype lowpass h(n), length taps+1."""
    assert taps % 2 == 0
    omega_c = np.pi * cutoff_ratio
    n = np.arange(taps + 1) - taps / 2
    with np.errstate(invalid="ignore", divide="ignore"):
        h_i = np.sin(omega_c * n) / (np.pi * n)
    h_i[taps // 2] = cutoff_ratio  # limit at n=0
    return (h_i * np.kaiser(taps + 1, beta)).astype(np.float64)


class PQMF(nn.Module):
    def __init__(self, subbands: int = 4, taps: int = 62,
                 cutoff_ratio: float = 0.15, beta: float = 9.0, device=None):
        super().__init__()
        self.subbands, self.taps = subbands, taps
        h_proto = design_prototype_filter(taps, cutoff_ratio, beta)
        n = np.arange(taps + 1) - (taps - 1) / 2
        h_a = np.zeros((subbands, taps + 1))
        h_s = np.zeros((subbands, taps + 1))
        for k in range(subbands):
            phase = (2 * k + 1) * (np.pi / (2 * subbands)) * n
            shift = (-1) ** k * np.pi / 4
            h_a[k] = 2 * h_proto * np.cos(phase + shift)
            h_s[k] = 2 * h_proto * np.cos(phase - shift)
        self.register_buffer("analysis_filter", torch.from_numpy(
            h_a.astype(np.float32))[:, None, :])
        self.register_buffer("synthesis_filter", torch.from_numpy(
            h_s.astype(np.float32))[None])
        self.to(device)

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T] -> subbands [B, T // S, S]."""
        y = F.conv1d(x[:, None, :], self.analysis_filter,
                     stride=self.subbands, padding=self.taps // 2)
        return y.transpose(1, 2)

    def synthesis(self, subbands: torch.Tensor) -> torch.Tensor:
        """subbands [B, T // S, S] -> x [B, T]: zero-stuffed by S (times
        S), then the synthesis bank."""
        s = self.subbands
        b, t, _ = subbands.shape
        up = subbands.new_zeros((b, s, t * s))
        up[:, :, ::s] = subbands.transpose(1, 2) * s
        return F.conv1d(up, self.synthesis_filter,
                        padding=self.taps // 2)[:, 0, :]
