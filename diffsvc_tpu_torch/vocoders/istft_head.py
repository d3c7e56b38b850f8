"""The iSTFT-head vocoder: a backbone at the mel frame rate and one inverse
STFT.

Counterpart of ``diffsvc_tpu/vocoders/istft_head.py:40-194``
(``IstftVocoderConfig``, ``init``, ``apply``, ``save_params``,
``load_params``, ``IstftVocoder``): a k=7 stem conv from the log10-mel
(+ a coarse-f0 embedding), LayerNorm, ``n_layers`` blocks of [k=3 conv,
LayerNorm, Linear -> tanh-GELU -> Linear, layer-scale residual], a final
LayerNorm, and a linear head to log-magnitude (clipped to [-12, 6]) and
phase, rendered by ``ops/istft.istft``.  Every LayerNorm runs at eps 1e-6
in f32.  With ``dtype=torch.bfloat16`` the backbone runs in bf16 and the
head and the iSTFT stay f32.

Checkpoints are the JAX package's ``.npz`` files: one array per leaf of
its parameter tree, keyed by the leaf's ``jax.tree_util.keystr`` path
(``['blocks'][0]['conv']['w']``) in its layouts (conv [k, in, out], linear
[in, out]); :func:`save_params` writes them and :func:`load_params` reads
them, through ``utils/convert.istft_jax_to_torch`` and its inverse
:func:`jax_tree`.  The family is trained in the repository
(``training/vocoder_task.py``); there are no community checkpoints.
"""

from __future__ import annotations

import os
import re
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.nn import true_f32_convs
from ..ops.istft import istft
from ..ops.pitch import f0_to_coarse
from .base import BaseVocoder, register_vocoder

LN_EPS = 1e-6


class IstftVocoderConfig(NamedTuple):
    num_mels: int = 128
    dim: int = 512
    n_layers: int = 8
    mlp_ratio: int = 3
    n_fft: int = 2048
    hop: int = 512
    sampling_rate: int = 44100
    use_f0: bool = True
    f0_bin: int = 256
    f0_min: float = 40.0
    f0_max: float = 1100.0

    @classmethod
    def from_hparams(cls, hp):
        return cls(
            num_mels=int(hp["audio_num_mel_bins"]),
            dim=int(hp.get("istft_dim", 512)),
            n_layers=int(hp.get("istft_layers", 8)),
            n_fft=int(hp["fft_size"]),
            hop=int(hp["hop_size"]),
            sampling_rate=int(hp["audio_sample_rate"]),
            use_f0=bool(hp.get("use_nsf", True)),
            f0_bin=int(hp.get("f0_bin", 256)),
            f0_min=float(hp.get("f0_min", 40.0)),
            f0_max=float(hp.get("f0_max", 1100.0)))


class Block(nn.Module):
    def __init__(self, d: int, mlp_ratio: int):
        super().__init__()
        self.conv = nn.Conv1d(d, d, 3, padding=1)
        self.ln = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp1 = nn.Linear(d, mlp_ratio * d)
        self.mlp2 = nn.Linear(mlp_ratio * d, d)
        # layer scale: each residual branch starts near the identity
        self.gamma = nn.Parameter(torch.full((d,), 1e-2))


class IstftHead(nn.Module):
    """The model's parameters, as JAX's ``init`` lays them out: torch's
    default init for the convs and linears, LayerNorms at (1, 0), the f0
    table N(0, 1/dim) with row 0 zero, gamma 1e-2."""

    def __init__(self, cfg: IstftVocoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.stem = nn.Conv1d(cfg.num_mels, d, 7, padding=3)
        self.stem_ln = nn.LayerNorm(d, eps=LN_EPS)
        self.blocks = nn.ModuleList(Block(d, cfg.mlp_ratio)
                                    for _ in range(cfg.n_layers))
        self.final_ln = nn.LayerNorm(d, eps=LN_EPS)
        self.head = nn.Linear(d, 2 * (cfg.n_fft // 2 + 1))
        if cfg.use_f0:
            self.f0_embed = nn.Embedding(cfg.f0_bin, d)
            with torch.no_grad():
                self.f0_embed.weight.normal_(0.0, d ** -0.5)
                self.f0_embed.weight[0].zero_()
        self.to(device)


def _ln(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps)


def apply(head: IstftHead, mel: torch.Tensor, f0=None, dtype=None
          ) -> torch.Tensor:
    """log10-mel [B, T, M] (+ f0 Hz [B, T]) -> wav [B, T * hop], f32.

    ``dtype=torch.bfloat16`` runs the backbone's convs and linears in bf16
    (its LayerNorms in f32); the head and the iSTFT stay f32."""
    cfg = head.cfg
    n_bins = cfg.n_fft // 2 + 1
    with true_f32_convs():
        x = head.stem(mel.transpose(1, 2)).transpose(1, 2)
        if cfg.use_f0 and f0 is not None:
            coarse = f0_to_coarse(f0, cfg.f0_bin, cfg.f0_min, cfg.f0_max)
            x = x + F.embedding(coarse, head.f0_embed.weight)
        x = _ln(head.stem_ln, x)
        dt = dtype or torch.float32
        x = x.to(dt)
        for blk in head.blocks:
            h = F.conv1d(x.transpose(1, 2), blk.conv.weight.to(dt),
                         blk.conv.bias.to(dt), padding=1).transpose(1, 2)
            h = _ln(blk.ln, h).to(dt)
            h = F.linear(h, blk.mlp1.weight.to(dt), blk.mlp1.bias.to(dt))
            h = F.gelu(h, approximate="tanh")
            h = F.linear(h, blk.mlp2.weight.to(dt), blk.mlp2.bias.to(dt))
            x = x + blk.gamma.to(dt) * h
        x = _ln(head.final_ln, x)
        out = head.head(x)                                 # [B, T, 2*bins]
    logmag = torch.clamp(out[..., :n_bins], -12.0, 6.0)
    phase = out[..., n_bins:]
    mag = torch.exp(logmag)
    wav = istft(mag * torch.cos(phase), mag * torch.sin(phase),
                n_fft=cfg.n_fft, hop=cfg.hop, length=mel.shape[1] * cfg.hop)
    return torch.clamp(wav, -1.0, 1.0).float()


# ---------------------------------------------------------------------------
# .npz checkpoints in the JAX package's layout
# ---------------------------------------------------------------------------

def jax_tree(head: IstftHead) -> dict:
    """The module's weights as JAX's parameter tree (numpy, JAX layouts)."""
    def arr(p):
        return p.detach().float().cpu().numpy()

    def conv(m):
        return {"w": arr(m.weight).transpose(2, 1, 0), "b": arr(m.bias)}

    def lin(m):
        return {"w": arr(m.weight).T, "b": arr(m.bias)}

    def ln(m):
        return {"scale": arr(m.weight), "bias": arr(m.bias)}

    tree = {"stem": conv(head.stem), "stem_ln": ln(head.stem_ln),
            "final_ln": ln(head.final_ln), "head": lin(head.head),
            "blocks": [{"conv": conv(b.conv), "ln": ln(b.ln),
                        "mlp1": lin(b.mlp1), "mlp2": lin(b.mlp2),
                        "gamma": arr(b.gamma)} for b in head.blocks]}
    if head.cfg.use_f0:
        tree["f0_embed"] = arr(head.f0_embed.weight)
    return tree


def _flatten(tree, path=""):
    """{keystr path: leaf} of a tree of dicts and lists (JAX's keystr:
    ``['name']`` for a dict key, ``[i]`` for a list index)."""
    if isinstance(tree, dict):
        items = ((f"{path}['{k}']", v) for k, v in tree.items())
    elif isinstance(tree, list):
        items = ((f"{path}[{i}]", v) for i, v in enumerate(tree))
    else:
        return {path: tree}
    out = {}
    for p, v in items:
        out.update(_flatten(v, p))
    return out


def _unflatten(flat: dict):
    """The tree of :func:`_flatten`'s keys (lists where the keys are
    indices)."""
    root = {}
    for key, leaf in flat.items():
        parts = [a if a else int(b)
                 for a, b in re.findall(r"\['([^']*)'\]|\[(\d+)\]", key)]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(isinstance(k, int) for k in n):
            return [lists(n[i]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}
    return lists(root)


def save_params(path: str, head: IstftHead) -> None:
    """Write the module as JAX's ``save_params`` writes its tree."""
    np.savez(path, **_flatten(jax_tree(head)))


def load_params(path: str, cfg: IstftVocoderConfig, device=None
                ) -> IstftHead:
    """A module on ``device`` from a ``save_params`` file of either
    package."""
    from ..utils.convert import istft_jax_to_torch, load_reference_state

    with np.load(path) as data:
        tree = _unflatten({k: data[k] for k in data.files})
    head = IstftHead(cfg)
    load_reference_state(head, istft_jax_to_torch(tree))
    return head.to(device)


@register_vocoder
class IstftVocoder(BaseVocoder):
    """Registry wrapper (``vocoder: IstftVocoder`` / ``istftvocoder``):
    ``vocoder_ckpt`` names a ``.npz`` of :func:`save_params`; without one
    the weights are the init drawn from seed 0."""

    def __init__(self, hp, device="cpu"):
        self.hp = hp
        self.device = torch.device(device)
        self.cfg = IstftVocoderConfig.from_hparams(hp)
        ckpt = str(hp.get("vocoder_ckpt", ""))
        if ckpt and os.path.isfile(ckpt):
            self.gen = load_params(ckpt, self.cfg, self.device)
            print(f"| Loaded IstftVocoder from {ckpt}")
        else:
            print(f"| IstftVocoder: no checkpoint at '{ckpt}' — random init")
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                self.gen = IstftHead(self.cfg)
            self.gen.to(self.device)
        self.gen.eval()

    @torch.no_grad()
    def spec2wav(self, mel, f0=None, seed: int = 0, randoms=None):
        """log10-mel [T, M] -> wav [T * hop] (numpy f32); f0 in Hz when the
        model embeds it.  ``seed`` and ``randoms`` are ignored (the head
        draws nothing)."""
        c = torch.as_tensor(np.asarray(mel, np.float32),
                            device=self.device)[None]
        f0_t = None
        if f0 is not None and self.cfg.use_f0:
            f0_t = torch.as_tensor(np.asarray(f0, np.float32),
                                   device=self.device)[None]
        return apply(self.gen, c, f0_t)[0].cpu().numpy()

    @staticmethod
    def wav2spec(inp_path, hp, device="cpu"):
        # the NSF family's mel, as the JAX wrapper delegates
        from .nsf_hifigan import NsfHifiGAN

        return NsfHifiGAN.wav2spec(inp_path, hp, device)
