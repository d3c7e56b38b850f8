"""The training stack's share of its roofline: model FLOPs of the residual
stack's steps (3x its forward, at the padded batch shape the kernels are
given) at the configuration's stated training precision, over the device
time of the stack's kernels (K4's forward and K4 / K5's backward: the
``tc``, ``tf32x3`` and ``ttc`` kernels) in the trace, %."""

import re

from benchmark import flops
from benchmark.metrics_common import kernel_seconds

KERNELS = re.compile(r"::(tc|tf32x3|ttc)::\w+")


def read(run):
    secs = kernel_seconds(run, KERNELS, "the training stack", bool(run.work))
    if secs is None:
        return None
    hp = run.config["hparams"]
    prec = run.config["precision"]["train_stack"]
    c, n_l = int(hp["residual_channels"]), int(hp["residual_layers"])
    e = flops.BYTES_OF[prec]
    least = 0.0
    for w in run.work:
        b, t = w["rows"], w["frames"]
        # x, skip and their gradients, the projected conditioner and its
        # gradient, the weights and their gradients, once each
        moved = e * (4 * b * t * c + 2 * n_l * b * t * 2 * c
                     + 2 * n_l * (3 * c * 2 * c + c * 2 * c))
        least += flops.bound_s(flops.train_model_flops(b, t, c, n_l), moved,
                               prec)
    return 100.0 * least / secs
