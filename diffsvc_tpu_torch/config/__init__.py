"""Config chain loading: the JAX-free loader of the reference package."""

from diffsvc_tpu.config.hparams import (HParams, hparams, load_config_chain,
                                        set_hparams)

__all__ = ["HParams", "set_hparams", "hparams", "load_config_chain"]
