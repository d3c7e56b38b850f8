"""ONNX export of the port's modules, and a numpy runtime to check it.

Counterpart of ``diffsvc_tpu/onnx/``: the reference's split graphs
(``{proj}_encoder/_denoise/_pred/_after.onnx``, reference onnx_export.py
+ modules/diff/diffusion_V2.py:252-352, opset 16), the DPM-Solver++ step
graph and the vocoder graphs, with no ``jax``, ``onnx``, ``onnxscript``
or ``google.protobuf``:

- ``wire``       — the protobuf wire format of the ONNX messages, by hand
                   (the counterpart of ``proto.py`` + ``onnx_pb2.py``).
- ``builder``    — GraphProto/ModelProto assembly (a copy of the JAX one).
- ``convert``    — ``torch.export`` ATen graph -> ONNX (constant folding,
                   dynamic time axes).
- ``runtime``    — numpy evaluator of the emitted op set (a copy).
- ``svc_export`` — the artifact builders on the port's modules.
- ``chain``      — the exported-graph PLMS / DPM-Solver++ loops and the
                   vocoder stage (``python -m diffsvc_tpu_torch.onnx.chain``).
"""

from . import wire  # noqa: F401
from .convert import export_onnx  # noqa: F401
from .runtime import OnnxRunner  # noqa: F401
