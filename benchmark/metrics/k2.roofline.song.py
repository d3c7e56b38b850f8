"""K2's share of its roofline: the least time the card could take for the
ladders the window ran (every denoiser evaluation of each PLMS trajectory
at the padded chunk shape the kernel is given, the projections and the
stack, at the denoiser's stated precision; inputs read once, output
written once), over the device time of K2's kernels (its projections and
epilogue and K1's layer kernels it launches) in the trace, %."""

import re

from benchmark import flops
from benchmark.metrics_common import kernel_seconds, ladder_shapes

KERNELS = re.compile(
    r"::(tc|tf32x3)::(gate_tc_kernel|out_tc_kernel|y0_kernel|gate_kernel|"
    r"out_kernel|in_proj_tc_kernel|epilogue_tc_kernel|in_proj_kernel|"
    r"skip_proj_kernel|out_proj_kernel)\b")


def read(run):
    shapes = ladder_shapes(run)
    secs = kernel_seconds(run, KERNELS, "K2", bool(shapes))
    if secs is None:
        return None
    hp = run.config["hparams"]
    prec = run.config["precision"]["denoiser"]
    c, n_l = int(hp["residual_channels"]), int(hp["residual_layers"])
    m = int(hp["audio_num_mel_bins"])
    evals = flops.sampler_evals(int(hp["K_step"]),
                                int(run.workload["entry_args"]["acc"]))
    least = 0.0
    for b, pad_t in shapes:
        least += flops.bound_s(b * evals * flops.eval_flops(pad_t, c, n_l, m),
                               b * flops.ladder_bytes(pad_t, c, n_l, m, evals,
                                                      prec), prec)
    return 100.0 * least / secs
