"""The port's op library: the hand-written Hopper kernels on the serving
path, registered with ``torch.library`` under the namespace
``diffsvc_tpu_torch``:

- ``residual_stack``: K1 (``diffnet_stack.py``);
- ``plms_ladder``: K2 (``plms_ladder.py``);
- ``vocoder_tail``: K3 (``vocoder_tail.py``).

Each op runs its kernel for CUDA tensors and its plain PyTorch version for
CPU tensors, and has a fake implementation for tracing; it has none for any
other device.  The wrappers of those modules call through the ops, so
``torch.export`` records them and a program written by
``infer/export.py`` calls the kernels.  Importing this package registers
the ops and touches no card (the kernels are built at the first CUDA
call): it is all a consumer of such a program needs of the port
(:func:`load_program`).
"""

from . import diffnet_stack, plms_ladder, vocoder_tail  # noqa: F401  (registers the ops)


def load_program(path: str):
    """A ``.pt2`` program written by ``infer/export.py``, loaded with
    ``torch.export.load``: a callable that runs it with cuDNN's f32
    convolutions in true f32, as the port's routes run them whatever the
    caller's ``torch.backends.cudnn.allow_tf32`` (``models.nn.
    true_f32_convs``, which this library does not import): a program
    records operators, not that flag, and PyTorch's default would run them
    as single-pass TF32."""
    import torch

    program = torch.export.load(path).module()

    def run(*args):
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return program(*args)
        finally:
            torch.backends.cudnn.allow_tf32 = prev

    return run
