"""ContentVec content encoder on the HuBERT trunk.

Counterpart of ``diffsvc_tpu/models/contentvec.py`` (reference
``network/hubert/vec_model.py``): a fairseq HuBERT checkpoint
(``checkpoint_best_legacy_500.pt``) loaded onto the port's HuBERT module
(``models/hubert.py``: the same 7-conv front end, conv positional
embedding and post-LN transformer), whose units are the layer-9 features
through ``final_proj`` -> [B, T, 256].  Unlike HuBERT-soft the waveform is
not padded by (400-320)/2.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..utils import convert
from .hubert import HubertConfig, HubertSoft

OUTPUT_LAYER = 9  # vec_model.py:40 "output_layer": 9


class ContentVec(HubertSoft):
    @torch.no_grad()
    def units(self, wav16k: torch.Tensor) -> torch.Tensor:
        """[B, L] 16 kHz -> [B, T, proj_dim]: layer-9 features, final_proj."""
        return self.proj(self.encode(wav16k, output_layer=OUTPUT_LAYER))


# fairseq HubertModel name -> the port's HuBERT module name (prefixes)
_NAMES = [("feature_extractor.conv_layers.0.2.", "feature_extractor.norm0."),
          *((f"feature_extractor.conv_layers.{i}.0.",
             f"feature_extractor.conv{i}.") for i in range(7)),
          ("post_extract_proj.", "feature_projection.projection."),
          ("layer_norm.", "feature_projection.norm."),
          ("encoder.pos_conv.0.", "positional_embedding.conv."),
          ("encoder.layer_norm.", "norm."),
          ("final_proj.", "proj.")]
_LAYER_NAMES = [("self_attn.out_proj.", "self_attn.out_proj."),
                ("self_attn_layer_norm.", "norm1."), ("fc1.", "linear1."),
                ("fc2.", "linear2."), ("final_layer_norm.", "norm2.")]


def fairseq_to_port(sd: Dict[str, torch.Tensor],
                    cfg: HubertConfig = HubertConfig()) -> Dict:
    """A fairseq HubertModel state dict (weight norm folded) as the port's
    HuBERT module's: the layers' separate q/k/v projections packed into
    ``in_proj_weight`` / ``in_proj_bias``; entries of neither (label
    embeddings, the mask embedding) are dropped."""
    sd = convert.fold_weight_norm(sd)
    out = {}
    for src, dst in _NAMES:
        for k, v in sd.items():
            if k.startswith(src):
                out[dst + k[len(src):]] = v
    for i in range(cfg.num_layers):
        pfx = f"encoder.layers.{i}."
        for src, dst in _LAYER_NAMES:
            for k, v in sd.items():
                if k.startswith(pfx + src):
                    out[pfx + dst + k[len(pfx + src):]] = v
        for part in ("weight", "bias"):
            out[f"{pfx}self_attn.in_proj_{part}"] = torch.cat(
                [torch.as_tensor(sd[f"{pfx}self_attn.{q}_proj.{part}"])
                 for q in ("q", "k", "v")])
    return out


def port_to_fairseq(sd: Dict[str, torch.Tensor],
                    cfg: HubertConfig = HubertConfig()) -> Dict:
    """The inverse of :func:`fairseq_to_port` (weight norm left folded):
    the port's HuBERT state dict under fairseq's names, ``in_proj``
    split into q/k/v."""
    names = _NAMES + [(f"encoder.layers.{i}.{src}", f"encoder.layers.{i}.{dst}")
                      for i in range(cfg.num_layers)
                      for src, dst in _LAYER_NAMES]
    out = {}
    for k, v in sd.items():
        if ".self_attn.in_proj_" in k:
            pfx, part = k.split(".self_attn.in_proj_")
            for name, t in zip("qkv", v.chunk(3)):
                out[f"{pfx}.self_attn.{name}_proj.{part}"] = t.clone()
            continue
        for src, dst in names:
            if k.startswith(dst):
                out[src + k[len(dst):]] = v.clone()
                break
    return out


def load(pt_path: str, device="cpu", cfg: HubertConfig = HubertConfig()
         ) -> ContentVec:
    """A fairseq ContentVec checkpoint (a pickle with 'model') as a
    :class:`ContentVec` on ``device``, in eval mode."""
    ckpt = convert.torch_load(pt_path)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    model = ContentVec(cfg)
    convert.load_reference_state(model, fairseq_to_port(
        {k: torch.as_tensor(v) for k, v in sd.items()}, cfg))
    return model.to(device).eval()
