"""Random-weight projects and synthetic inputs, made from a seed.

The repository holds no trained checkpoints, so the smoke run on the card
(``chip_smoke.py``) and the CPU tests build a project with random weights
in the reference's file formats and convert synthetic voiced clips through
it.  :func:`write_project` writes

- the diffusion ``.ckpt`` (``{"state_dict": {"model.<name>": ...}}``),
- the NSF-HiFiGAN ``generator`` file with weight-normed convs plus its
  sibling ``config.json``,
- optionally a HuBERT-soft ``.pt`` with the weight-normed positional conv,
- and a ``config.yaml`` pointing at them,

so the port and the JAX package load them through their normal loaders.
It can also write, each in its checkpoint's own layout: the HiFi-GAN V1
generator of the 24 kHz profile (``generator_v1`` + ``config.json``, or
``config.yaml`` + ``model_ckpt_steps_*.ckpt``), a reference pe checkpoint,
torchcrepe's ``full.pth`` and a fairseq ContentVec checkpoint.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
import yaml

from ..config import load_config_chain
from ..models.contentvec import ContentVec, port_to_fairseq
from ..models.diffusion import GaussianDiffusion
from ..models.hubert import HubertConfig, HubertSoft
from ..models.pe import PitchExtractor
from ..ops.crepe import Crepe
from ..vocoders.generator import Generator, HifiGanConfig


def randomize(module: torch.nn.Module, seed: int) -> None:
    """Deterministic weights: torch's default init drawn from ``seed``."""
    torch.manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters") and m is not module:
            m.reset_parameters()


def randomize_norms(module: torch.nn.Module, seed: int) -> None:
    """Affine weights 1 + 0.1 N, biases 0.1 N and, for BatchNorm, running
    means 0.1 N and variances 0.5 + U(0, 1), drawn from ``seed``, so that no
    normalization of a random-weight model is the identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.modules.batchnorm._BatchNorm,
                              torch.nn.GroupNorm, torch.nn.LayerNorm)):
                n = m.weight.numel()
                m.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                    m.running_var.copy_(0.5 + torch.rand(n, generator=g))


def _weight_norm(sd: dict, names, dim: int = 0) -> dict:
    """Split ``<name>.weight`` into weight_g / weight_v (norm over every dim
    but ``dim``), the layout torch's weight_norm saves.  weight_v is a scaled
    copy, so loading only comes out right if the loader folds the norm
    back."""
    out = dict(sd)
    for name in names:
        w = out.pop(f"{name}.weight")
        axes = tuple(i for i in range(w.dim()) if i != dim)
        out[f"{name}.weight_g"] = torch.sqrt((w ** 2).sum(dim=axes,
                                                          keepdim=True))
        out[f"{name}.weight_v"] = w * 1.7
    return out


def _generator_state(voc_h: dict, use_nsf: bool, seed: int):
    """A random generator and its state dict with weight-normed convs."""
    gen = Generator(HifiGanConfig.from_dict(voc_h, use_nsf=use_nsf))
    randomize(gen, seed)
    wn = ["conv_pre", "conv_post"] + [f"ups.{i}" for i in range(len(gen.ups))]
    for i, blk in enumerate(gen.resblocks):
        for key in ("convs1", "convs2", "convs"):
            wn += [f"resblocks.{i}.{key}.{d}"
                   for d in range(len(getattr(blk, key, ())))]
    return gen, _weight_norm(gen.state_dict(), wn)


def write_nsf_generator(dirpath: str, voc_h: dict, seed: int = 0) -> Generator:
    """NSF-HiFiGAN ``model`` ({"generator": state dict}) + ``config.json``."""
    gen, sd = _generator_state(voc_h, True, seed)
    os.makedirs(dirpath, exist_ok=True)
    torch.save({"generator": sd}, os.path.join(dirpath, "model"))
    with open(os.path.join(dirpath, "config.json"), "w") as f:
        json.dump(voc_h, f)
    return gen


def write_hifigan(dirpath: str, voc_h: dict, use_nsf: bool = True,
                  seed: int = 0, layout: str = "json") -> Generator:
    """The 24 kHz HiFi-GAN generator in a reference vocoder directory:
    ``layout`` "json" writes ``generator_v1`` ({"generator": state dict})
    + ``config.json`` (the released V1 files), "yaml" a trainer checkpoint
    ``model_ckpt_steps_1000.ckpt`` ({"state_dict": {"model_gen": ...}}) +
    ``config.yaml``."""
    gen, sd = _generator_state(voc_h, use_nsf, seed)
    os.makedirs(dirpath, exist_ok=True)
    if layout == "json":
        torch.save({"generator": sd}, os.path.join(dirpath, "generator_v1"))
        with open(os.path.join(dirpath, "config.json"), "w") as f:
            json.dump(voc_h, f)
    else:
        torch.save({"state_dict": {"model_gen": sd}, "global_step": 1000},
                   os.path.join(dirpath, "model_ckpt_steps_1000.ckpt"))
        with open(os.path.join(dirpath, "config.yaml"), "w") as f:
            yaml.safe_dump(voc_h, f)
    return gen


def write_pwg(dirpath: str, generator_params: dict, hop_size: int,
              seed: int = 0):
    """An official ParallelWaveGAN directory: ``config.yaml``
    (``generator_params``, ``hop_size``), ``checkpoint-400000steps.pkl``
    ({"model": {"generator": state dict}}, every conv weight-normed) and
    ``stats.npy`` (the StandardScaler's [mean; scale], mean 0.3 N and scale
    0.5 + U(0, 1) per mel bin).  Returns the generator (its weights
    folded)."""
    from ..vocoders.pwg import ParallelWaveGANGenerator, PWGConfig

    cfg = PWGConfig.from_dict(generator_params)
    gen = ParallelWaveGANGenerator(cfg)
    randomize(gen, seed)
    convs = [n for n, m in gen.named_modules()
             if isinstance(m, torch.nn.Conv1d)]
    os.makedirs(dirpath, exist_ok=True)
    torch.save({"model": {"generator": _weight_norm(gen.state_dict(),
                                                    convs)},
                "steps": 400000},
               os.path.join(dirpath, "checkpoint-400000steps.pkl"))
    with open(os.path.join(dirpath, "config.yaml"), "w") as f:
        yaml.safe_dump({"generator_params": dict(generator_params),
                        "hop_size": int(hop_size)}, f)
    rng = np.random.RandomState(seed)
    m = cfg.aux_channels
    np.save(os.path.join(dirpath, "stats.npy"), np.stack(
        [0.3 * rng.randn(m), 0.5 + rng.rand(m)]).astype(np.float32))
    return gen


def write_istft(path: str, cfg, seed: int = 0):
    """The iSTFT head's ``.npz`` (``istft_head.save_params``) with torch's
    default init drawn from ``seed`` and its norms off (1, 0)
    (:func:`randomize_norms`).  Returns the module."""
    from ..vocoders.istft_head import IstftHead, save_params

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        head = IstftHead(cfg)
    randomize_norms(head, seed)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_params(path, head)
    return head


def write_pe(path: str, hp, seed: int = 0) -> PitchExtractor:
    """A reference pe checkpoint (``{"state_dict": {"model.<name>": ...}}``,
    modules/fastspeech/pe.py's names) at ``hp``'s widths."""
    model = PitchExtractor(hp)
    randomize(model, seed)
    randomize_norms(model, seed + 1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"state_dict": {f"model.{k}": v.clone()
                               for k, v in model.state_dict().items()},
                "global_step": 60000}, path)
    return model.eval()


def write_crepe(path: str, seed: int = 0) -> Crepe:
    """torchcrepe's 'full' ``full.pth`` (a bare state dict)."""
    model = Crepe()
    randomize(model, seed)
    randomize_norms(model, seed + 1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(model.state_dict(), path)
    return model.eval()


def write_contentvec(path: str, cfg: HubertConfig, seed: int = 0
                     ) -> ContentVec:
    """A fairseq ContentVec checkpoint (``{"model": state dict}`` with
    fairseq's HubertModel names, separate q/k/v projections and the
    weight-normed positional conv)."""
    model = ContentVec(cfg)
    randomize(model, seed)
    sd = port_to_fairseq(model.state_dict(), cfg)
    sd = _weight_norm(sd, ["encoder.pos_conv.0"], dim=2)
    sd["label_embs_concat"] = torch.zeros(504, cfg.proj_dim)
    sd["mask_emb"] = torch.zeros(cfg.dim)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"model": sd}, path)
    return model.eval()


def write_hubert(path: str, cfg: HubertConfig, seed: int = 0) -> HubertSoft:
    """HuBERT-soft ``.pt`` (bare state dict, weight-normed positional conv)."""
    model = HubertSoft(cfg)
    randomize(model, seed)
    sd = _weight_norm(model.state_dict(), ["positional_embedding.conv"],
                      dim=2)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(sd, path)
    return model


def write_project(root: str, config: dict, voc_h: dict,
                  hubert_cfg: HubertConfig | None = None, *,
                  pe: bool = False, crepe: bool = False,
                  vec_cfg: HubertConfig | None = None):
    """Write a project under ``root`` and return (config.yaml, ckpt path).

    :param config: the config.yaml's entries: a whole hparams dict, or one
        that inherits others through ``base_config``.  The paths of the
        files written are added to it.
    :param voc_h: the vocoder's geometry (its ``config.json``): an
        NSF-HiFiGAN ``model`` for an NSF vocoder, else a HiFi-GAN V1
        ``generator_v1`` (NSF source as the config's ``use_nsf`` says)
    :param hubert_cfg: write a HuBERT-soft ``.pt`` of this size; None writes
        none (the caller then supplies units another way)
    :param pe: write a pe checkpoint (``pe_ckpt``) at the config's widths
    :param crepe: write CREPE's ``full.pth`` (``crepe_path``)
    :param vec_cfg: write a ContentVec checkpoint of this size
        (``vec_path``)

    The weights are torch's default init drawn from seeds 0 (diffusion),
    1 (vocoder), 2 (HuBERT), 3 (pe), 4 (CREPE) and 5 (ContentVec), the
    normalizations of pe and CREPE drawn by :func:`randomize_norms`.
    """
    os.makedirs(root, exist_ok=True)
    cfg_fn = os.path.join(root, "config.yaml")
    with open(cfg_fn, "w") as f:
        yaml.safe_dump(dict(config), f)
    hp = load_config_chain(cfg_fn)
    nsf = "nsf" in str(hp.get("vocoder", "")).lower()
    cfg = dict(config,
               vocoder_ckpt=os.path.join(root, "nsf_hifigan", "model") if nsf
               else os.path.join(root, "hifigan"),
               hubert_path=os.path.join(root, "hubert", "hubert_soft.pt"))
    if pe:
        cfg["pe_ckpt"] = os.path.join(root, "pe",
                                      "model_ckpt_steps_60000.ckpt")
    if crepe:
        cfg["crepe_path"] = os.path.join(root, "crepe", "full.pth")
    if vec_cfg is not None:
        cfg["vec_path"] = os.path.join(root, "vec",
                                       "checkpoint_best_legacy_500.pt")
    with open(cfg_fn, "w") as f:
        yaml.safe_dump(cfg, f)
    hp = load_config_chain(cfg_fn)
    model = GaussianDiffusion(hp)
    randomize(model, 0)
    ckpt = os.path.join(root, "model_ckpt_steps_1000.ckpt")
    torch.save({"state_dict": {f"model.{k}": v.clone()
                               for k, v in model.state_dict().items()},
                "epoch": 0, "global_step": 1000}, ckpt)
    if nsf:
        write_nsf_generator(os.path.dirname(cfg["vocoder_ckpt"]), voc_h, 1)
    else:
        write_hifigan(cfg["vocoder_ckpt"], voc_h,
                      bool(hp.get("use_nsf", False)), 1)
    if hubert_cfg is not None:
        write_hubert(cfg["hubert_path"], hubert_cfg, 2)
    if pe:
        write_pe(cfg["pe_ckpt"], hp, 3)
    if crepe:
        write_crepe(cfg["crepe_path"], 4)
    if vec_cfg is not None:
        write_contentvec(cfg["vec_path"], vec_cfg, 5)
    return cfg_fn, ckpt


def voiced_wav(secs: float, sr: int, f0: float = 220.0, gaps=(),
               seed: int = 0) -> np.ndarray:
    """A vibrato tone with two harmonics and a little noise; ``gaps`` are
    (start_s, end_s) spans set to silence."""
    t = np.arange(int(sr * secs)) / sr
    ph = 2 * np.pi * np.cumsum(f0 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))) / sr
    wav = 0.3 * np.sin(ph) + 0.1 * np.sin(2 * ph) + 0.05 * np.sin(3 * ph)
    wav += 0.002 * np.random.RandomState(seed).randn(len(t))
    for a, b in gaps:
        wav[int(a * sr): int(b * sr)] = 0.0
    return wav.astype(np.float32)


def _sidecar_units(wav: np.ndarray, sr: int, proj: np.ndarray) -> np.ndarray:
    """Units on the 16 kHz / 320 HuBERT grid: the framed 16 kHz audio times
    a fixed projection (content-correlated, no HuBERT weights needed)."""
    t = np.arange(len(wav)) / sr
    n16 = int(len(wav) * 16000 / sr)
    wav16 = np.interp(np.arange(n16) / 16000, t, wav).astype(np.float32)
    n_units = max((n16 + 2 * 40) // 320, 1)
    frames = np.zeros((n_units, 320), np.float32)
    for j in range(n_units):
        seg = wav16[j * 320: j * 320 + 320]
        frames[j, : len(seg)] = seg
    return frames @ proj


def make_dataset(raw_dir: str, sr: int = 44100, n_clips: int = 16,
                 dur: float = 2.0, hidden: int = 256) -> None:
    """Synthetic singing: ``clipNN.wav`` (three harmonics with vibrato,
    phrase envelopes and a little noise, one note per clip) and its
    ``clipNN.npy`` sidecar units, the files ``tools/train_demo_tpu.py``'s
    ``make_dataset`` writes, byte for byte (same ``RandomState(0)`` draws in
    the same order)."""
    from .audio_io import save_wav

    os.makedirs(raw_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    proj = (rng.randn(320, hidden) / np.sqrt(320)).astype(np.float32)
    notes = [196.0, 220.0, 247.0, 262.0, 294.0, 330.0, 349.0, 392.0]
    for i in range(n_clips):
        t = np.arange(int(sr * dur)) / sr
        f0c = notes[i % len(notes)] * 2 ** (
            0.04 * np.sin(2 * np.pi * (4.5 + 0.3 * i) * t)
            + 0.2 * np.sin(2 * np.pi * 0.4 * t + i))
        ph = np.cumsum(2 * np.pi * f0c / sr)
        wav = (0.35 * np.sin(ph) + 0.2 * np.sin(2 * ph)
               + 0.1 * np.sin(3 * ph) + 0.01 * rng.randn(len(t)))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * 0.8 * t + i)  # phrasing
        wav = (wav * env).astype(np.float32)
        save_wav(wav, f"{raw_dir}/clip{i:02d}.wav", sr)
        np.save(f"{raw_dir}/clip{i:02d}.npy", _sidecar_units(wav, sr, proj))


def make_real_dataset(raw_dir: str, wav_path: str, sr: int = 44100,
                      n_clips: int = 0, dur: float = 2.0,
                      hidden: int = 256) -> int:
    """A vocal recording in :func:`make_dataset`'s layout: non-overlapping
    ``dur``-second windows as ``clipNN.wav`` with sidecar units from the
    same projection.  ``n_clips`` <= 0 keeps every full window.  Returns
    the number of clips written."""
    from scipy.io import wavfile

    from .audio_io import resample, save_wav

    os.makedirs(raw_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    proj = (rng.randn(320, hidden) / np.sqrt(320)).astype(np.float32)
    sr0, w = wavfile.read(wav_path)
    if w.ndim > 1:
        w = w.mean(-1)
    if np.issubdtype(w.dtype, np.integer):
        w = w.astype(np.float32) / float(np.iinfo(w.dtype).max)
    w = w.astype(np.float32)
    if sr0 != sr:
        w = resample(w, sr0, sr)
    n = int(sr * dur)
    starts = list(range(0, len(w) - n + 1, n))
    if n_clips and n_clips > 0:
        starts = starts[:n_clips]
    for i, s in enumerate(starts):
        wav = np.asarray(w[s:s + n], np.float32)
        save_wav(wav, f"{raw_dir}/clip{i:02d}.wav", sr)
        np.save(f"{raw_dir}/clip{i:02d}.npy", _sidecar_units(wav, sr, proj))
    return len(starts)


def stack_inputs(dtype, device, b: int, t: int, c: int, layers: int) -> dict:
    """Operands of K1 (``ops/hopper/diffnet_stack.residual_stack``) with O(1)
    activations: x0 [B,T,C], sb [L,B,C], cond_proj [L,B,T,2C],
    wd [L,3,C,2C], bd [L,2C], wo [L,C,2C], bo [L,2C]."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device, dtype)

    return dict(x0=r(b, t, c).abs(), sb=r(layers, b, c, scale=0.3),
                cond_proj=r(layers, b, t, 2 * c, scale=0.5),
                wd=r(layers, 3, c, 2 * c, scale=1 / math.sqrt(3 * c)),
                bd=r(layers, 2 * c, scale=0.1),
                wo=r(layers, c, 2 * c, scale=1 / math.sqrt(c)),
                bo=r(layers, 2 * c, scale=0.1))
