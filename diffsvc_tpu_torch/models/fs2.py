"""FastSpeech2-style condition encoder.

Counterpart of ``diffsvc_tpu/models/fs2.py`` (reference
``modules/fastspeech/fs2.py:21-255``).  With the default ``no_fs2: true``::

    cond = gather(pad(hubert, 1), mel2ph)            # frame-aligned units
         + pitch_embed[f0_to_coarse(denorm_f0(f0, uv))]
         (+ energy_embed[coarse(energy)])            # if use_energy_embed
         (+ spk_embed)                               # if use_spk_*
    cond *= (mel2ph > 0)

With ``no_fs2: false`` the units first run through an FFT-block
``encoder`` (``tts_modules.FFTBlocks``) as ``hubert * sqrt(hidden) +
positions`` with the all-zero unit rows as padding, and ``skip_decoder=False``
adds the ``decoder`` stack's auxiliary ``mel_out``.  Parameter names follow
the reference (``pitch_embed.weight``, ``mel_out.*``,
``encoder.layers.{i}.op.*`` ...).  The embeddings are looked up through
``nn.embed``, whose backward repeats bit for bit on the card.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.pitch import denorm_f0, energy_to_coarse, f0_to_coarse
from . import nn as fnn
from . import tts_modules


class FastSpeech2(nn.Module):
    def __init__(self, hp):
        super().__init__()
        h = int(hp["hidden_size"])
        self.hidden_size = h
        self.no_fs2 = bool(hp.get("no_fs2", True))
        self.dropout = float(hp.get("dropout", 0.1))
        self.use_pitch_embed = bool(hp.get("use_pitch_embed", True))
        self.use_energy_embed = bool(hp.get("use_energy_embed", False))
        self.use_spk_id = bool(hp.get("use_spk_id", False))
        self.use_spk_embed = bool(hp.get("use_spk_embed", False))
        self.use_uv = bool(hp.get("use_uv", False))
        self.pitch_norm = hp.get("pitch_norm", "log")
        self.f0_mean = float(hp.get("f0_mean", 0.0) or 0.0)
        self.f0_std = float(hp.get("f0_std", 1.0) or 1.0)
        self.f0_bin = int(hp.get("f0_bin", 256))
        self.f0_min = float(hp.get("f0_min", 50.0))
        self.f0_max = float(hp.get("f0_max", 1100.0))
        self.mel_out = nn.Linear(h, int(hp["audio_num_mel_bins"]))
        if self.use_pitch_embed:
            self.pitch_embed = nn.Embedding(300, h, padding_idx=0)
        if self.use_energy_embed:
            self.energy_embed = nn.Embedding(256, h, padding_idx=0)
        if self.use_spk_id:
            self.spk_embed_proj = nn.Embedding(int(hp.get("num_spk", 1)) + 1, h)
        elif self.use_spk_embed:
            self.spk_embed_proj = nn.Linear(256, h)
        if not self.no_fs2:
            heads = int(hp.get("num_heads", 2))
            self.encoder = tts_modules.FFTBlocks(
                h, int(hp.get("enc_layers", 4)),
                int(hp.get("enc_ffn_kernel_size", 9)), heads)
            self.decoder = tts_modules.FFTBlocks(
                h, int(hp.get("dec_layers", 4)),
                int(hp.get("dec_ffn_kernel_size", 9)), heads)
        self.init_weights()

    @torch.no_grad()
    def init_weights(self) -> None:
        """Embeddings drawn from N(0, hidden^-0.5) with the padding row zero,
        as the JAX package's ``normal_embedding`` (the reference's Embedding
        helper); linears keep torch's default init."""
        for m in self.modules():
            if isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, 0.0, m.embedding_dim ** -0.5)
                if m.padding_idx is not None:
                    m.weight[m.padding_idx].zero_()

    def forward(self, hubert, mel2ph, f0, uv=None, energy=None,
                spk_embed=None, skip_decoder: bool = True,
                generator=None) -> dict:
        """:param hubert: [B, T_ph, H]; mel2ph: [B, T_mel] int (0 = pad);
        f0: [B, T_mel] log2-normalized; returns 'decoder_inp' [B, T_mel, H],
        'f0_denorm', 'mel2ph' (and 'mel_out' from the FS2-full decoder when
        not ``skip_decoder``).  ``generator``: the FS2-full stacks' dropout
        draws (training); None runs them deterministic."""
        ret = {"mel2ph": mel2ph}
        rate = self.dropout if generator is not None else 0.0
        if not self.no_fs2:
            x = hubert * math.sqrt(self.hidden_size)
            x = x + tts_modules.positional_encoding_for(x)
            hubert = self.encoder(x, (hubert == 0).all(dim=-1), rate,
                                  generator)
        padded = nn.functional.pad(hubert, (0, 0, 1, 0))
        idx = mel2ph.long()[:, :, None].expand(-1, -1, hubert.shape[-1])
        decoder_inp = torch.gather(padded, 1, idx)
        tgt_nonpadding = (mel2ph > 0).to(decoder_inp.dtype)[:, :, None]
        if self.use_pitch_embed:
            f0_denorm = denorm_f0(f0, uv, pitch_norm=self.pitch_norm,
                                  use_uv=self.use_uv,
                                  pitch_padding=mel2ph == 0,
                                  f0_mean=self.f0_mean, f0_std=self.f0_std)
            ret["f0_denorm"] = f0_denorm
            # padded frames carry f0=0 -> coarse bin 1 (not the padding row),
            # as in the reference; the nonpadding multiply zeroes them
            pitch = f0_to_coarse(f0_denorm, self.f0_bin, self.f0_min,
                                 self.f0_max)
            decoder_inp = decoder_inp + fnn.embed(self.pitch_embed, pitch)
        if self.use_energy_embed and energy is not None:
            decoder_inp = decoder_inp + fnn.embed(self.energy_embed,
                                                  energy_to_coarse(energy))
        if self.use_spk_id and spk_embed is not None:
            decoder_inp = decoder_inp + fnn.embed(self.spk_embed_proj,
                                                  spk_embed)[:, None, :]
        elif self.use_spk_embed and spk_embed is not None:
            decoder_inp = decoder_inp + self.spk_embed_proj(spk_embed)[:, None, :]
        ret["decoder_inp"] = decoder_inp = decoder_inp * tgt_nonpadding
        if not self.no_fs2 and not skip_decoder:
            x = decoder_inp + tts_modules.positional_encoding_for(decoder_inp)
            x = self.decoder(x, mel2ph == 0, rate, generator)
            ret["mel_out"] = self.mel_out(x) * tgt_nonpadding
        return ret
