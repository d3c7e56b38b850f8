"""diffsvc_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of diffsvc_tpu.

The module layout mirrors ``diffsvc_tpu`` so each counterpart is found under
the same path (``models/diffnet.py`` <-> ``diffsvc_tpu/models/diffnet.py``).
Public tensor functions are channels-last [B, T, C] like the JAX package;
modules keep the reference diff-svc state-dict names, so reference ``.ckpt``,
``hubert_soft.pt`` and NSF-HiFiGAN ``generator`` files load directly.

The TPU Pallas kernels on the conversion path are hand-written CUDA kernels
for sm_90a under ``csrc/``, wrapped in ``ops/hopper/``.  Every wrapper runs
its kernel for CUDA tensors and its plain PyTorch version for CPU tensors;
K1-K3, the serving kernels, are registered ops (``torch.ops.
diffsvc_tpu_torch.*``), so the programs ``infer/export.py`` writes call them.

This package never imports JAX, and no module of ``diffsvc_tpu``: what it
needs of that package's JAX-free modules (the config loader, the wav I/O and
others) it keeps as its own copies.
"""

__version__ = "0.1.0"
