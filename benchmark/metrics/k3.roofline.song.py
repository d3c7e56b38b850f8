"""K3's share of its roofline: the least time for the vocoder tails the
window ran (the resblocks from the first stage of at most 128 channels,
the later transposed convolutions and conv_post, at the padded chunk
shapes, at the vocoder's stated precision; inputs, injections, weights
read once, the wave written once), over the device time of K3's kernels
in the trace, %."""

import re

from benchmark import flops
from benchmark.metrics_common import kernel_seconds, tail_shapes

KERNELS = re.compile(r"::tail::(conv_tc_kernel|convt_tc_kernel|"
                     r"pair_tc_kernel)\b")


def read(run):
    shapes = tail_shapes(run)
    secs = kernel_seconds(run, KERNELS, "K3", bool(shapes))
    if secs is None:
        return None
    voc = run.config["vocoder"]
    prec = run.config["precision"]["vocoder"]
    least = sum(flops.bound_s(b * flops.tail_flops(voc, t_mel),
                              b * flops.tail_bytes(voc, t_mel), prec)
                for b, t_mel in shapes)
    return 100.0 * least / secs
