"""Checkpoint loading and layout conversion.

- Reference checkpoints load straight into the port's modules: the module
  names are the reference's, so a ``.ckpt`` state dict goes through
  ``load_state_dict`` after its ``model.`` prefix is stripped.  Weight norm
  (NSF-HiFiGAN, the HuBERT positional conv) is folded at load, as
  ``diffsvc_tpu/utils/convert_torch.py`` does.
- :func:`jax_to_torch` turns the JAX package's parameter pytrees (numpy
  arrays) into the port's state dicts, inverting the layouts of
  ``convert_torch.py``: Conv1d HIO [k, in, out] -> [out, in, k]; ConvT
  [k, out, in] -> [in, out, k]; Linear [in, out] -> [out, in].  The
  vocoder families' converters (the iSTFT head, MelGAN and its
  discriminators, HiFi-GAN's MPD and MSD with their weight-norm ``v``/``g``
  and spectral-norm ``w_bar`` leaves, PQMF's filters) are here too; PWG
  needs none, its modules keep the official layout.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict

import numpy as np
import torch


def torch_load(path: str) -> Dict:
    """Unpickle a reference checkpoint (these files are pickles written by
    torch; load only files you trust)."""
    return torch.load(path, map_location="cpu", weights_only=False)


def strip_prefix(sd: Dict, prefix: str) -> Dict:
    n = len(prefix)
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}


def fold_weight_norm(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold weight_g/weight_v pairs into plain ``weight`` entries: the norm
    runs over every axis where g is broadcast (dim=0 for the usual weight
    norm, dim=2 for the HuBERT positional conv), in float64."""
    out = {}
    for k, v in sd.items():
        if k.endswith("weight_g"):
            continue
        if k.endswith("weight_v"):
            base = k[: -len("weight_v")]
            g = sd[base + "weight_g"].double()
            vv = v.double()
            axes = tuple(i for i in range(vv.dim())
                         if i >= g.dim() or g.shape[i] == 1)
            norm = torch.sqrt((vv ** 2).sum(dim=axes, keepdim=True))
            out[base + "weight"] = (g * vv / torch.clamp(norm, min=1e-12)).float()
        else:
            out[k] = v
    return out


def load_reference_state(module: torch.nn.Module, sd: Dict) -> None:
    """``load_state_dict`` that requires every module parameter and
    ignores extra reference entries (buffers such as the diffusion tables,
    unused heads)."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    missing, _ = module.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} parameters of "
                       f"{type(module).__name__}, e.g. {missing[:3]}")


def load_ckpt_state_dict(ckpt_path: str, prefix: str = "model.") -> Dict:
    """State dict of a reference trainer checkpoint with ``prefix``
    stripped.  A directory picks its latest ``model_ckpt_steps_*.ckpt``."""
    if os.path.isdir(ckpt_path):
        cands = glob.glob(os.path.join(ckpt_path, "model_ckpt_steps_*.ckpt"))
        if not cands:
            raise FileNotFoundError(f"no checkpoints in {ckpt_path}")
        ckpt_path = max(cands, key=lambda x: int(re.findall(r"steps_(\d+)", x)[0]))
    ckpt = torch_load(ckpt_path)
    sd = ckpt.get("state_dict", ckpt)
    if prefix and any(k.startswith(prefix) for k in sd):
        sd = strip_prefix(sd, prefix)
    return sd


# ---------------------------------------------------------------------------
# JAX pytree (numpy) -> torch state dict
# ---------------------------------------------------------------------------

def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{name}.bias"] = _t(p["b"])


def _conv(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(2, 1, 0))
    if "b" in p:
        sd[f"{name}.bias"] = _t(p["b"])


def _layer_norm(sd, name, p):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _fft_blocks(sd, prefix, p):
    """``tts_modules`` FFT-block params -> the reference's FFTBlocks names
    (the inverse of ``convert_torch.convert_fft_blocks``)."""
    for i, lp in enumerate(p["layers"]):
        base = f"{prefix}.layers.{i}.op"
        att = lp["attn"]
        _layer_norm(sd, f"{base}.layer_norm1", lp["ln1"])
        sd[f"{base}.self_attn.in_proj_weight"] = _t(np.concatenate(
            [np.asarray(att[k]["w"]).T for k in ("q", "k", "v")]))
        _linear(sd, f"{base}.self_attn.out_proj", att["out"])
        _layer_norm(sd, f"{base}.layer_norm2", lp["ln2"])
        _conv(sd, f"{base}.ffn.ffn_1", lp["ffn"]["conv"])
        _linear(sd, f"{base}.ffn.ffn_2", lp["ffn"]["out"])
    if "ln" in p:
        _layer_norm(sd, f"{prefix}.layer_norm", p["ln"])


def diffusion_jax_to_torch(params: Dict) -> Dict[str, torch.Tensor]:
    """{'fs2', 'denoise_fn'} JAX params -> GaussianDiffusion state dict:
    the FS2-full encoder and decoder when present, DiffNet or the FFT
    denoiser (``candidate_decoder``, recognized by ``get_decode_inp``)."""
    sd = {}
    fs2 = params["fs2"]
    for part in ("encoder", "decoder"):
        if part in fs2:
            _fft_blocks(sd, f"fs2.{part}", fs2[part])
    _linear(sd, "fs2.mel_out", fs2["mel_out"])
    for name in ("pitch_embed", "energy_embed"):
        if name in fs2:
            sd[f"fs2.{name}.weight"] = _t(fs2[name])
    if "spk_embed_proj" in fs2:
        if isinstance(fs2["spk_embed_proj"], dict):
            _linear(sd, "fs2.spk_embed_proj", fs2["spk_embed_proj"])
        else:
            sd["fs2.spk_embed_proj.weight"] = _t(fs2["spk_embed_proj"])
    dn = params["denoise_fn"]
    _conv(sd, "denoise_fn.input_projection", dn["input_projection"])
    _linear(sd, "denoise_fn.mlp.0", dn["mlp"]["w1"])
    _linear(sd, "denoise_fn.mlp.2", dn["mlp"]["w2"])
    if "get_decode_inp" in dn:
        _linear(sd, "denoise_fn.get_decode_inp", dn["get_decode_inp"])
        _linear(sd, "denoise_fn.get_mel_out", dn["get_mel_out"])
        sd["denoise_fn.pos_embed_alpha"] = _t(dn["pos_embed_alpha"])
        _fft_blocks(sd, "denoise_fn", dn["blocks"])
        return sd
    layers = dn["layers"]
    n_layers = np.asarray(layers["dilated_conv"]["w"]).shape[0]
    for i in range(n_layers):
        for name, conv in (("dilated_conv", True),
                           ("diffusion_projection", False),
                           ("conditioner_projection", True),
                           ("output_projection", True)):
            p = {k: np.asarray(v)[i] for k, v in layers[name].items()}
            (_conv if conv else _linear)(
                sd, f"denoise_fn.residual_layers.{i}.{name}", p)
    _conv(sd, "denoise_fn.skip_projection", dn["skip_projection"])
    _conv(sd, "denoise_fn.output_projection", dn["output_projection"])
    return sd


def generator_jax_to_torch(params: Dict) -> Dict[str, torch.Tensor]:
    """HiFi-GAN/NSF generator JAX params -> Generator state dict."""
    sd = {}
    _conv(sd, "conv_pre", params["conv_pre"])
    _conv(sd, "conv_post", params["conv_post"])
    for i, p in enumerate(params["ups"]):
        _conv(sd, f"ups.{i}", p)   # [k, out, in] -> [in, out, k]
    idx = 0
    for stage in params["resblocks"]:
        for blk in stage:
            for key, convs in blk.items():
                for d, p in enumerate(convs):
                    _conv(sd, f"resblocks.{idx}.{key}.{d}", p)
            idx += 1
    if "m_source" in params:
        _linear(sd, "m_source.l_linear", params["m_source"]["l_linear"])
        for i, p in enumerate(params["noise_convs"]):
            _conv(sd, f"noise_convs.{i}", p)
    return sd


def hubert_jax_to_torch(params: Dict) -> Dict[str, torch.Tensor]:
    """HuBERT-soft JAX params -> HubertSoft state dict."""
    sd = {}
    fe = params["feature_extractor"]
    for i in range(7):
        _conv(sd, f"feature_extractor.conv{i}", fe[f"conv{i}"])
    _layer_norm(sd, "feature_extractor.norm0", fe["norm0"])
    _layer_norm(sd, "feature_projection.norm",
                params["feature_projection"]["norm"])
    _linear(sd, "feature_projection.projection",
            params["feature_projection"]["projection"])
    _conv(sd, "positional_embedding.conv",
          params["positional_embedding"]["conv"])
    _layer_norm(sd, "norm", params["norm"])
    for i, layer in enumerate(params["encoder"]):
        pfx = f"encoder.layers.{i}"
        att = layer["attn"]
        sd[f"{pfx}.self_attn.in_proj_weight"] = _t(np.concatenate(
            [np.asarray(att[k]["w"]).T for k in ("q", "k", "v")]))
        sd[f"{pfx}.self_attn.in_proj_bias"] = _t(np.concatenate(
            [np.asarray(att[k]["b"]) for k in ("q", "k", "v")]))
        _linear(sd, f"{pfx}.self_attn.out_proj", att["out"])
        _layer_norm(sd, f"{pfx}.norm1", layer["ln1"])
        _linear(sd, f"{pfx}.linear1", layer["ffn"]["w1"])
        _linear(sd, f"{pfx}.linear2", layer["ffn"]["w2"])
        _layer_norm(sd, f"{pfx}.norm2", layer["ln2"])
    _linear(sd, "proj", params["proj"])
    return sd


def jax_to_torch(params: Dict) -> Dict[str, torch.Tensor]:
    """Dispatch on the pytree's structure: diffusion model, generator or
    HuBERT-soft."""
    if "denoise_fn" in params:
        return diffusion_jax_to_torch(params)
    if "conv_pre" in params:
        return generator_jax_to_torch(params)
    if "feature_extractor" in params:
        return hubert_jax_to_torch(params)
    raise ValueError(f"unrecognized parameter tree with keys {sorted(params)}")


# ---------------------------------------------------------------------------
# The vocoder families
# ---------------------------------------------------------------------------

def istft_jax_to_torch(params: Dict) -> Dict[str, torch.Tensor]:
    """iSTFT-head JAX params (``istft_head.init``'s tree) -> IstftHead
    state dict."""
    sd = {}
    _conv(sd, "stem", params["stem"])
    _layer_norm(sd, "stem_ln", params["stem_ln"])
    _layer_norm(sd, "final_ln", params["final_ln"])
    _linear(sd, "head", params["head"])
    for i, blk in enumerate(params["blocks"]):
        _conv(sd, f"blocks.{i}.conv", blk["conv"])
        _layer_norm(sd, f"blocks.{i}.ln", blk["ln"])
        _linear(sd, f"blocks.{i}.mlp1", blk["mlp1"])
        _linear(sd, f"blocks.{i}.mlp2", blk["mlp2"])
        sd[f"blocks.{i}.gamma"] = _t(blk["gamma"])
    if "f0_embed" in params:
        sd["f0_embed.weight"] = _t(params["f0_embed"])
    return sd


def melgan_jax_to_torch(params: Dict) -> Dict[str, torch.Tensor]:
    """MelGAN generator JAX params -> MelGANGenerator state dict."""
    sd = {}
    _conv(sd, "conv_in", params["conv_in"])
    _conv(sd, "conv_out", params["conv_out"])
    for i, up in enumerate(params["ups"]):
        _conv(sd, f"ups.{i}", up)
        for j, blk in enumerate(params["blocks"][i]):
            for name in ("c1", "c2", "skip"):
                _conv(sd, f"blocks.{i}.{j}.{name}", blk[name])
    return sd


def melgan_discriminator_jax_to_torch(params, prefix: str = ""
                                      ) -> Dict[str, torch.Tensor]:
    """MelGAN discriminator JAX params (one conv per layer) ->
    MelGANDiscriminator state dict: the first conv at ``layers.0.1``, the
    middle ones at ``layers.{i}.0``, the last at ``layers.{n-1}``.  A list
    of such lists (the multi-scale discriminator) goes under
    ``discriminators.{i}.``."""
    if isinstance(params[0], (list, tuple)):
        sd = {}
        for i, p in enumerate(params):
            sd.update(melgan_discriminator_jax_to_torch(
                p, f"{prefix}discriminators.{i}."))
        return sd
    sd = {}
    last = len(params) - 1
    for i, p in enumerate(params):
        name = {0: "layers.0.1", last: f"layers.{last}"}.get(
            i, f"layers.{i}.0")
        _conv(sd, prefix + name, p)
    return sd


def _reparam_conv(sd, name, p):
    """A discriminator conv in the parameterization its leaves name:
    weight norm (``v``, ``g``), spectral norm (``w_bar``) or plain."""
    if "v" in p:
        sd[f"{name}.weight_v"] = _t(np.asarray(p["v"]).transpose(2, 1, 0))
        sd[f"{name}.weight_g"] = _t(p["g"])
    elif "w_bar" in p:
        sd[f"{name}.weight_bar"] = _t(
            np.asarray(p["w_bar"]).transpose(2, 1, 0))
    else:
        sd[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(2, 1, 0))
    sd[f"{name}.bias"] = _t(p["b"])


def hifigan_discriminator_jax_to_torch(params: list
                                       ) -> Dict[str, torch.Tensor]:
    """MPD (``init_mpd``) or MSD (``init_msd``) JAX params -> the
    MultiPeriodDiscriminator / MultiScaleDiscriminator state dict."""
    sd = {}
    for i, d in enumerate(params):
        for j, c in enumerate(d["convs"]):
            _reparam_conv(sd, f"discriminators.{i}.convs.{j}", c)
        _reparam_conv(sd, f"discriminators.{i}.conv_post", d["conv_post"])
    return sd


def pqmf_jax_to_torch(pqmf) -> Dict[str, torch.Tensor]:
    """A JAX ``PQMF``'s filters (``h_analysis`` / ``h_synthesis`` [S, K])
    -> the PQMF module's buffers."""
    return {"analysis_filter": _t(pqmf.h_analysis)[:, None, :],
            "synthesis_filter": _t(pqmf.h_synthesis)[None]}
