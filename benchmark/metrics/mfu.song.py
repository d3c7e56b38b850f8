"""Model FLOPs of the songs' real (unpadded) voiced samples converted in
the window (HuBERT-soft, the conditioner's projection, every denoiser
evaluation of the sampler, the vocoder; ``benchmark/flops.py``), over the
window, as a share of 989 TFLOP/s (dense bf16, the highest rate of any
operand type the port uses), %."""

from benchmark import flops
from benchmark.metrics_common import chunk_samples


def read(run):
    acc = int(run.workload["entry_args"]["acc"])
    total = sum(flops.conversion_flops(run.config, n, acc)
                for n in chunk_samples(run))
    if not total:
        return None
    return 100.0 * total / run.counters["window_s"] / flops.MFU_PEAK
