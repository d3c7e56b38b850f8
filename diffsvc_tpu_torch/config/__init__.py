"""Config chain loading (a copy of the reference package's JAX-free loader)."""

from .hparams import HParams, hparams, load_config_chain, set_hparams

__all__ = ["HParams", "set_hparams", "hparams", "load_config_chain"]
