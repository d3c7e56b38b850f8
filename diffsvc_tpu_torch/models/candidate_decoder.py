"""The FFT denoiser, the transformer alternative to DiffNet
(``diff_decoder_type: fft``).

Counterpart of ``diffsvc_tpu/models/candidate_decoder.py:18-71``
(reference ``network/diff/candidate_decoder.py``): the 1x1 input
projection of the noisy mel, the diffusion-step MLP (sinusoidal embedding,
Linear, mish, Linear), ``get_decode_inp`` over ``[x, cond, t_emb]``, a
padding mask where that projection is all zero, positions scaled by
``pos_embed_alpha``, the FFT blocks and ``get_mel_out``.  State-dict names
are the reference's (``input_projection``, ``mlp.0``, ``mlp.2``,
``get_decode_inp``, ``get_mel_out``, ``pos_embed_alpha``,
``layers.{i}.op.*``, ``layer_norm``).

No TPU kernel computes it: the JAX package runs it as plain XLA and never
routes it through the ladder kernel, so on the card it runs as plain
PyTorch too (its samplers are ``diffusion.p_sample_*_scan``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import nn as fnn
from .tts_modules import FFTBlocks, linear, param


class FFTDecoder(FFTBlocks):
    def __init__(self, in_dims: int = 80, hidden_size: int = 256,
                 residual_channels: int = 256, dec_layers: int = 4,
                 dec_ffn_kernel_size: int = 9, num_heads: int = 2):
        super().__init__(hidden_size, dec_layers, dec_ffn_kernel_size,
                         num_heads)
        dim = residual_channels
        self.residual_channels = dim
        self.input_projection = nn.Conv1d(in_dims, dim, 1)
        nn.init.kaiming_normal_(self.input_projection.weight)
        self.mlp = nn.Sequential(nn.Linear(dim, dim * 4), nn.Mish(),
                                 nn.Linear(dim * 4, dim))
        self.get_decode_inp = nn.Linear(hidden_size + 2 * dim, hidden_size)
        self.get_mel_out = nn.Linear(hidden_size, in_dims)
        self.pos_embed_alpha = nn.Parameter(torch.ones(1))

    @classmethod
    def from_hparams(cls, hp) -> "FFTDecoder":
        return cls(in_dims=int(hp["audio_num_mel_bins"]),
                   hidden_size=int(hp["hidden_size"]),
                   residual_channels=int(hp["residual_channels"]),
                   dec_layers=int(hp.get("dec_layers", 4)),
                   dec_ffn_kernel_size=int(hp.get("dec_ffn_kernel_size", 9)),
                   num_heads=int(hp.get("num_heads", 2)))

    def forward(self, spec, diffusion_step, cond, wdt=None):
        """spec [B, T, M] and cond [B, T, H] in the compute dtype,
        diffusion_step [B] -> the noise prediction [B, T, M] in f32.

        ``wdt`` (the compute dtype) rounds every weight through it, as the
        JAX package casts its parameters; the activations follow JAX's
        promotion: the input projection in the compute dtype, the step MLP
        in f32, and from the concatenation on (which promotes to f32) f32."""
        w = param(self.input_projection.weight, spec, wdt)[:, :, 0]
        x = F.linear(spec, w, param(self.input_projection.bias, spec, wdt))
        step = fnn.sinusoidal_pos_emb(diffusion_step, self.residual_channels)
        step = linear(self.mlp[2], fnn.mish(linear(self.mlp[0], step, wdt)),
                      wdt)
        t_emb = step[:, None, :].expand(-1, x.shape[1], -1)
        h = linear(self.get_decode_inp,
                   torch.cat([x.float(), cond.float(), t_emb], dim=-1), wdt)
        padding_mask = h.abs().sum(-1) == 0
        pos = fnn.sinusoidal_positional_embedding(h.shape[1], h.shape[2], 1,
                                                  device=h.device)
        h = h + param(self.pos_embed_alpha, h, wdt)[0] * pos[None]
        h = super().forward(h, padding_mask, wdt=wdt)
        return linear(self.get_mel_out, h, wdt)
