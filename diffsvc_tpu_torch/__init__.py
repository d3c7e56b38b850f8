"""diffsvc_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of diffsvc_tpu.

The module layout mirrors ``diffsvc_tpu`` so each counterpart is found under
the same path (``models/diffnet.py`` <-> ``diffsvc_tpu/models/diffnet.py``).
Public tensor functions are channels-last [B, T, C] like the JAX package;
modules keep the reference diff-svc state-dict names, so reference ``.ckpt``,
``hubert_soft.pt`` and NSF-HiFiGAN ``generator`` files load directly.

The TPU Pallas kernels on the conversion path are hand-written CUDA kernels
for sm_90a under ``csrc/``, wrapped in ``ops/hopper/``.  Every wrapper runs
its kernel for CUDA tensors and its plain PyTorch version for CPU tensors.

This package never imports JAX.  The only ``diffsvc_tpu`` modules it uses are
the JAX-free config loader and wav I/O.
"""

__version__ = "0.1.0"
