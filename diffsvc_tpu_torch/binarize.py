"""Offline binarization with the port (reference ``preprocessing/binarize.py``,
the JAX package's ``binarize.py``):

    python -m diffsvc_tpu_torch.binarize --config configs/config_44k.yaml \
        [--device cuda|cpu]

Features run on the card (the mel and HuBERT-soft; ``--device cpu`` asks
for the CPU), the f0 tracker on the host.  The train split's spec_min /
spec_max are written back into the config file.
"""

from .config import hparams, set_hparams
from .data.binarizer import binarize
from .run import device_arg

if __name__ == "__main__":
    set_hparams(print_hparams=False)
    binarize(hparams, device=device_arg())
