"""PitchExtractor ("pe"): mel -> (f0, uv) CNN, used at inference to take
f0 from the generated mel for the vocoder (the 24 kHz profile).

Counterpart of ``diffsvc_tpu/models/pe.py`` (reference
``modules/fastspeech/pe.py``): a 3-layer conv prenet (k5, BatchNorm), two
residual ConvStacks blocks (k5, GroupNorm of 16-channel groups) and a
5-layer PitchPredictor head (channel LayerNorm, sinusoidal positions scaled
by a learned alpha) giving [f0_norm, uv logit] per frame.  The module names
are the reference's (``mel_prenet.layers.{i}.{0,2}``,
``mel_encoder.conv.{i}.conv.conv`` / ``.norm``,
``pitch_predictor.conv.{i}.{1,3}``, ``pitch_predictor.pos_embed_alpha``),
so a reference checkpoint loads with ``load_state_dict`` and the JAX
package's ``pe.convert`` reads this module's ``state_dict()``.  cuDNN's
convolutions run in true f32 (``nn.true_f32_convs``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.pitch import denorm_f0
from . import nn as fnn


class _Wrap(nn.Module):
    """A holder of one ``conv`` (the reference's ConvNorm)."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv


class _Block(nn.Module):
    """One residual ConvStacks block: ``conv.conv`` then ``norm``."""

    def __init__(self, h: int, k: int):
        super().__init__()
        self.conv = _Wrap(nn.Conv1d(h, h, k, padding=k // 2))
        self.norm = nn.GroupNorm(h // 16, h)


class PitchExtractor(nn.Module):
    def __init__(self, hp, conv_layers: int = 2):
        super().__init__()
        h = int(hp["hidden_size"])
        ph = int(hp.get("predictor_hidden", -1))
        ph = ph if ph > 0 else h
        k = int(hp.get("predictor_kernel", 5))
        self.hp = hp
        prenet = nn.Module()
        prenet.layers = nn.ModuleList()
        c_in = int(hp["audio_num_mel_bins"])
        for _ in range(3):
            prenet.layers.append(nn.Sequential(
                nn.Conv1d(c_in, h, 5, padding=2), nn.ReLU(),
                nn.BatchNorm1d(h)))
            c_in = h
        prenet.out_proj = nn.Linear(h, h)
        self.mel_prenet = prenet
        enc = nn.Module()
        enc.in_proj = nn.Linear(h, h)
        enc.conv = nn.ModuleList([_Block(h, 5) for _ in range(conv_layers)])
        enc.out_proj = nn.Linear(h, h)
        self.mel_encoder = enc
        pp = nn.Module()
        pp.conv = nn.ModuleList()
        c_in = h
        for _ in range(5):
            pp.conv.append(nn.Sequential(
                nn.ConstantPad1d(((k - 1) // 2, (k - 1) // 2), 0.0),
                nn.Conv1d(c_in, ph, k), nn.ReLU(),
                fnn.ChannelLayerNorm(ph), nn.Dropout(0.0)))
            c_in = ph
        pp.linear = nn.Linear(ph, 2)
        pp.pos_embed_alpha = nn.Parameter(torch.ones(1))
        self.pitch_predictor = pp

    @torch.no_grad()
    def forward(self, mel: torch.Tensor) -> dict:
        """mel [B, T, M] log10 -> {'pitch_pred' [B, T, 2],
        'f0_denorm_pred' [B, T]}; all-zero (padding) frames give f0 0."""
        return self.compute(mel)

    def compute(self, mel: torch.Tensor) -> dict:
        """:meth:`forward` with autograd (the pe task's loss).  The prenet's
        BatchNorm is its eval form written out, ``(x - mean) / sqrt(var +
        eps) * w + b``, as JAX's ``batch_norm_eval``: the pe task trains the
        running statistics as parameters, as the JAX task does."""
        hp = self.hp
        padding = mel.abs().sum(-1) == 0
        keep = 1.0 - padding.float()[:, :, None]            # [B, T, 1]
        with fnn.true_f32_convs():
            # f32 mels in pe's own dtype (f64 for a reference)
            x = mel.float().to(self.mel_prenet.out_proj.weight.dtype
                               ).transpose(1, 2)
            for conv, _, bn in self.mel_prenet.layers:
                x = torch.relu(conv(x))
                x = ((x - bn.running_mean[:, None])
                     * torch.rsqrt(bn.running_var[:, None] + bn.eps)
                     * bn.weight[:, None] + bn.bias[:, None])
                x = x * keep.transpose(1, 2)
            x = self.mel_prenet.out_proj(x.transpose(1, 2)) * keep
            x = self.mel_encoder.in_proj(x)
            for blk in self.mel_encoder.conv:
                y = blk.conv.conv(x.transpose(1, 2)).transpose(1, 2)
                x = x + torch.relu(fnn.group_norm(y, blk.norm))
            x = self.mel_encoder.out_proj(x)
            pp = self.pitch_predictor
            pos = fnn.sinusoidal_positional_embedding(
                x.shape[1], x.shape[2], offset=1, device=x.device)
            x = (x + pp.pos_embed_alpha[0] * pos[None]).transpose(1, 2)
            for layer in pp.conv:
                x = layer(x)
        pitch_pred = pp.linear(x.transpose(1, 2))
        uv = pitch_pred[:, :, 1] > 0 \
            if hp.get("pitch_type", "frame") == "frame" else None
        f0 = denorm_f0(pitch_pred[:, :, 0], uv,
                       pitch_norm=hp.get("pitch_norm", "log"),
                       use_uv=bool(hp.get("use_uv", False)),
                       pitch_padding=padding,
                       f0_mean=float(hp.get("f0_mean", 0.0) or 0.0),
                       f0_std=float(hp.get("f0_std", 1.0) or 1.0))
        return {"pitch_pred": pitch_pred, "f0_denorm_pred": f0}


def load(ckpt_path: str, hp, device="cpu") -> PitchExtractor:
    """A reference pe checkpoint (``model_ckpt_steps_*.ckpt``, or its
    directory) as a :class:`PitchExtractor` on ``device``, in eval mode."""
    from ..utils import convert

    sd = convert.load_ckpt_state_dict(ckpt_path)
    n_blocks = 0
    while f"mel_encoder.conv.{n_blocks}.conv.conv.weight" in sd:
        n_blocks += 1
    model = PitchExtractor(hp, conv_layers=n_blocks)
    convert.load_reference_state(model, sd)
    return model.to(device).eval()
