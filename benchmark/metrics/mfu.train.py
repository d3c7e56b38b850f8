"""Model FLOPs of the window's steps on their real (unpadded) frames (3x
the denoiser's forward and the conditioner's projection per real frame),
over the window, as a share of 989 TFLOP/s (dense bf16), %."""

from benchmark import flops


def read(run):
    hp = run.config["hparams"]
    total = sum(flops.diffnet_train_flops(1, n, hp)
                for w in run.work for n in w["lengths"])
    if not total:
        return None
    return 100.0 * total / run.counters["window_s"] / flops.MFU_PEAK
