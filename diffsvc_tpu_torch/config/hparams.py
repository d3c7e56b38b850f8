"""YAML config-chain loader with reference-compatible semantics.

Behavioral parity with the reference config system (see SURVEY.md §2.1;
reference ``utils/hparams.py:23-117``):

- each YAML file may declare ``base_config:`` (str or list); bases are loaded
  depth-first and the child's keys override the parents',
- the work dir ``checkpoints/<exp_name>/config.yaml`` holds the complete saved
  config; unless ``reset`` is given, the saved config takes precedence over
  the file config,
- ``--hparams "k=v,k2=v2"`` string overrides with type coercion,
- flags ``infer`` / ``debug`` / ``validate`` / ``exp_name`` are injected.

Unlike the reference's global mutable dict imported at module scope, the
framework threads an explicit :class:`HParams` object through constructors.
A module-level ``hparams`` singleton is kept only for CLI compatibility.

A copy of ``diffsvc_tpu/config/hparams.py``, so that the port loads no
module of the JAX package.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Optional

import yaml


class HParams(dict):
    """A dict with attribute access. The single typed config object threaded
    through every constructor in the framework."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def copy(self) -> "HParams":
        return HParams(dict.copy(self))


# Singleton updated by set_hparams() for CLI entry points. Library code should
# accept an HParams argument instead of importing this.
hparams = HParams()


def _override_config(old: Dict, new: Dict) -> None:
    """Recursively merge ``new`` into ``old`` (child overrides parent)."""
    for k, v in new.items():
        if isinstance(v, dict) and k in old and isinstance(old[k], dict):
            _override_config(old[k], v)
        else:
            old[k] = v


def load_config_chain(config_fn: str, *, _seen: Optional[set] = None) -> Dict:
    """Load a YAML file and its ``base_config`` chain, depth-first,
    child-overrides-parent."""
    _seen = _seen if _seen is not None else set()
    config_fn = os.path.abspath(config_fn) if os.path.exists(config_fn) else config_fn
    if config_fn in _seen:
        return {}
    _seen.add(config_fn)
    with open(config_fn, encoding="utf-8") as f:
        cfg = yaml.safe_load(f) or {}
    out: Dict = {}
    bases = cfg.get("base_config", [])
    if isinstance(bases, str):
        bases = [bases]
    for base in bases:
        if not os.path.isabs(base) and not os.path.exists(base):
            # resolve relative to the including file
            cand = os.path.join(os.path.dirname(config_fn), base)
            if os.path.exists(cand):
                base = cand
        _override_config(out, load_config_chain(base, _seen=_seen))
    cfg.pop("base_config", None)
    _override_config(out, cfg)
    return out


def _coerce(old_val: Any, new_val: str) -> Any:
    """Coerce a CLI string override to the type of the existing value."""
    if isinstance(old_val, bool):
        return new_val.lower() in ("true", "1", "yes")
    if isinstance(old_val, int):
        try:
            return int(new_val)
        except ValueError:
            return float(new_val)
    if isinstance(old_val, float):
        return float(new_val)
    if isinstance(old_val, (list, dict)) or old_val is None:
        try:
            return yaml.safe_load(new_val)
        except yaml.YAMLError:
            return new_val
    return new_val


def parse_hparams_string(hp: Dict, hparams_str: str) -> None:
    """Apply ``k=v,k2=v2`` overrides in place, with type coercion."""
    if not hparams_str:
        return
    for kv in hparams_str.split(","):
        if not kv.strip():
            continue
        k, _, v = kv.partition("=")
        k, v = k.strip(), v.strip()
        hp[k] = _coerce(hp.get(k), v)


def set_hparams(
    config: str = "",
    exp_name: str = "",
    hparams_str: str = "",
    print_hparams: bool = True,
    global_hparams: bool = True,
    reset: bool = False,
    infer: bool = False,
    validate: bool = False,
) -> HParams:
    """Reference-compatible config resolution.

    Precedence (low→high): base_config chain < config file < saved work-dir
    config (unless ``reset``) < ``hparams_str`` overrides.
    """
    if config == "" and exp_name == "":
        parser = argparse.ArgumentParser(description="diffsvc_tpu")
        parser.add_argument("--config", type=str, default="")
        parser.add_argument("--exp_name", type=str, default="")
        parser.add_argument("--hparams", type=str, default="")
        parser.add_argument("--infer", action="store_true")
        parser.add_argument("--validate", action="store_true")
        parser.add_argument("--reset", action="store_true")
        parser.add_argument("--debug", action="store_true")
        args, _ = parser.parse_known_args()
        config, exp_name, hparams_str = args.config, args.exp_name, args.hparams
        reset, infer, validate = args.reset, args.infer, args.validate
        debug = args.debug
    else:
        debug = False

    hp = HParams()
    if config:
        hp.update(load_config_chain(config))
        # the binarizer writes spec_min/max back into hp['config_path']
        # (base_binarizer.py:174-183); the reference relies on the YAML
        # declaring it — default to the --config file so the write-back
        # works out of the box
        if not hp.get("config_path"):
            hp["config_path"] = config

    if exp_name:
        hp["exp_name"] = exp_name
    work_dir = hp.get("work_dir") or (
        os.path.join("checkpoints", exp_name) if exp_name else ""
    )
    if work_dir:
        hp["work_dir"] = work_dir
        saved_fn = os.path.join(work_dir, "config.yaml")
        if not reset and os.path.exists(saved_fn):
            saved = load_config_chain(saved_fn)
            # saved config takes precedence over the file config
            _override_config(hp, saved)
            hp["work_dir"] = work_dir

    parse_hparams_string(hp, hparams_str)

    hp["infer"] = infer
    hp["debug"] = debug
    hp["validate"] = validate
    if exp_name:
        hp["exp_name"] = exp_name

    if global_hparams:
        hparams.clear()
        hparams.update(hp)
    if print_hparams:
        print("| Hparams chains:", config)
        print(
            "| Hparams:",
            ", ".join(f"{k}: {hp[k]}" for k in sorted(hp) if not isinstance(hp[k], (list, dict))),
        )
    return hp


def save_hparams(hp: HParams, work_dir: Optional[str] = None) -> str:
    """Dump the complete resolved config into the work dir (done at train
    start, mirroring the reference)."""
    work_dir = work_dir or hp["work_dir"]
    os.makedirs(work_dir, exist_ok=True)
    fn = os.path.join(work_dir, "config.yaml")
    with open(fn, "w", encoding="utf-8") as f:
        yaml.safe_dump(dict(hp), f, allow_unicode=True, sort_keys=True)
    return fn


def write_back_spec_stats(hp: HParams, spec_min: List[float], spec_max: List[float]) -> None:
    """The binarizer writes computed spec_min/spec_max back into the config
    file (reference ``preprocessing/base_binarizer.py:174-183``)."""
    hp["spec_min"] = [float(v) for v in spec_min]
    hp["spec_max"] = [float(v) for v in spec_max]
    cfg_fn = hp.get("config_path", "")
    if cfg_fn and os.path.exists(cfg_fn):
        with open(cfg_fn, encoding="utf-8") as f:
            cfg = yaml.safe_load(f) or {}
        cfg["spec_min"] = hp["spec_min"]
        cfg["spec_max"] = hp["spec_max"]
        with open(cfg_fn, "w", encoding="utf-8") as f:
            yaml.safe_dump(cfg, f, allow_unicode=True, sort_keys=True)
