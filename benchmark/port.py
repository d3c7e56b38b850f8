"""How the benchmark builds the system under test, ``diffsvc_tpu_torch``,
through its own loaders.

The port loads reference-format checkpoints with ``torch.load``.  The
benchmark makes the weights on the card from the seed
(``benchmark/weights.py``), writes only small placeholder files and the
config, and serves the checkpoints' contents from memory for the duration
of the constructor, so that a run writes no weights to disk and the port's
loaders, weight-norm folding and placement run as for a real checkpoint.
"""

from __future__ import annotations

import contextlib
import json
import os

import yaml


def serving(config: dict) -> dict:
    """The configuration as conversion runs it: its hparams with its
    ``serving`` group applied (for svc44k the bf16 denoiser)."""
    return dict(config, hparams=dict(config["hparams"],
                                     **config.get("serving", {})))


@contextlib.contextmanager
def checkpoints_in_memory(payload: dict):
    """``torch.load`` of a path in ``payload`` returns its object."""
    import torch

    real = torch.load
    table = {os.path.abspath(k): v for k, v in payload.items()}

    def load(path, *args, **kwargs):
        key = os.path.abspath(os.fspath(path)) if isinstance(
            path, (str, os.PathLike)) else None
        if key in table:
            return table[key]
        return real(path, *args, **kwargs)

    torch.load = load
    try:
        yield
    finally:
        torch.load = real


def write_project(root: str, config: dict) -> dict:
    """config.yaml (the configuration file's hparams with the checkpoint
    paths) and the placeholder files under ``root``; returns the paths."""
    os.makedirs(root, exist_ok=True)
    nsf = "nsf" in str(config["hparams"].get("vocoder", "")).lower()
    # NSF-HiFiGAN: <dir>/model + config.json; HiFi-GAN V1: the directory,
    # holding generator_v1 + config.json
    p = {"config": os.path.join(root, "config.yaml"),
         "model": os.path.join(root, "model_ckpt_steps_0.ckpt"),
         "hubert": os.path.join(root, "hubert", "hubert_soft.pt"),
         "vocoder": os.path.join(root, "vocoder",
                                 "model" if nsf else "generator_v1")}
    if "pe" in config:
        p["pe"] = os.path.join(root, "pe", "model_ckpt_steps_0.ckpt")
    for k in ("model", "hubert", "vocoder", "pe"):
        if k not in p:
            continue
        os.makedirs(os.path.dirname(p[k]), exist_ok=True)
        with open(p[k], "wb") as f:
            f.write(b"in memory")
    voc = {k: v for k, v in config["vocoder"].items() if k != "source"}
    with open(os.path.join(root, "vocoder", "config.json"), "w") as f:
        json.dump(voc, f)
    paths = dict(hubert_path=p["hubert"],
                 vocoder_ckpt=p["vocoder"] if nsf
                 else os.path.dirname(p["vocoder"]))
    if "pe" in p:
        paths["pe_ckpt"] = p["pe"]
    hp = dict(config["hparams"], **paths)
    with open(p["config"], "w") as f:
        yaml.safe_dump(hp, f)
    return p


def payload(paths: dict, w: dict) -> dict:
    """The checkpoints' contents in the layouts the port's loaders read."""
    out = {paths["model"]: {"state_dict": {
        f"model.{k}": v for k, v in w["diffusion"].items()}},
        paths["hubert"]: dict(w["hubert"]),
        paths["vocoder"]: {"generator": dict(w["generator"])}}
    if "pe" in paths:
        out[paths["pe"]] = {"state_dict": {
            f"model.{k}": v for k, v in w["pe"].items()}}
    return out


def build_svc(root: str, config: dict, w: dict, device: str,
              hubert_cfg=None):
    """A ``diffsvc_tpu_torch.infer.svc.Svc`` over the weights ``w``.
    ``hubert_cfg`` (a dict) builds HuBERT-soft at other widths than the
    loader's default (the CPU tests' tiny model)."""
    from diffsvc_tpu_torch.infer import hubert_encoder
    from diffsvc_tpu_torch.infer.svc import Svc

    paths = write_project(root, config)
    real_load = hubert_encoder.load
    if hubert_cfg is not None:
        from diffsvc_tpu_torch.models.hubert import HubertConfig

        cfg = HubertConfig(**{k: int(v) for k, v in hubert_cfg.items()
                              if k in HubertConfig._fields})

        def load(pt_path, device="cpu", cfg_=cfg):
            return real_load(pt_path, device, cfg_)

        hubert_encoder.load = load
    try:
        with checkpoints_in_memory(payload(paths, w)):
            return Svc("bench", paths["config"], True, paths["model"],
                       device=device)
    finally:
        hubert_encoder.load = real_load
