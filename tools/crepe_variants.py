#!/usr/bin/env python3
"""Where CREPE's network time goes on one NVIDIA GPU: the port's 'full'
network (random weights from a seed) on the frames of 14 s of 16 kHz audio
(2,801 frames), each layer's convolution run the ways cuDNN offers, all in
true f32 (TF32 off).

    python3 tools/crepe_variants.py [--frames N] [--chunk N] [--hold-gib G]
                                    [--heuristic]

Variants (per layer, then the whole network in ``FRAME_CHUNK`` calls):

    conv2d         ``ops/crepe.Crepe`` as it is: [N, C, T, 1] Conv2d
    conv2d_bench   the same with ``torch.backends.cudnn.benchmark`` on
    conv1d         F.conv1d on [N, C, T] with the [out, in, k] weights
    conv1d_bench   the same with benchmark on

Each line: ms per call (CUDA events, 3 calls after a warm-up), the
layer's FLOPs over that time, and the rel-L2 of its output against the
first variant's.  Before them, the whole network on all frames
(``crepe.posteriors`` as shipped: cuDNN's benchmark choosing each
algorithm; with ``--heuristic`` the benchmark held off, cuDNN's heuristic
choosing), with the card's free memory.  PyTorch keeps the algorithm it
found for a shape for the rest of the process, whichever way it chose, so
compare the two in separate processes.  ``--hold-gib`` first takes that
much device memory (as a process that has run other work holds its
allocator's cache), so the workspace cuDNN can get is smaller.  The
card's name and power limit come first.
"""

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch                                          # noqa: E402
import torch.nn.functional as F                       # noqa: E402

from diffsvc_tpu_torch.ops import crepe               # noqa: E402
from diffsvc_tpu_torch.utils.synth import (randomize,  # noqa: E402
                                           randomize_norms)


def ms_per_call(fn, reps=3):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def conv(x4, layer, k, s, variant):
    """One layer's padded convolution on [N, C, T, 1] input."""
    lo = (k - s) // 2 if s > 1 else (k - 1) // 2
    hi = k - s - lo if s > 1 else k // 2
    xp = F.pad(x4, (0, 0, lo, hi))
    if variant.startswith("conv1d"):
        return F.conv1d(xp[..., 0], layer.weight[..., 0], layer.bias,
                        stride=s)[..., None]
    return F.conv2d(xp, layer.weight, layer.bias, stride=(s, 1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2801)
    ap.add_argument("--chunk", type=int, default=crepe.FRAME_CHUNK)
    ap.add_argument("--hold-gib", type=float, default=0.0)
    ap.add_argument("--heuristic", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("crepe_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 3
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    held = torch.empty(int(args.hold_gib * 2 ** 30), dtype=torch.uint8,
                       device=dev) if args.hold_gib else None
    full_model_first(args, dev)
    model = crepe.Crepe()
    randomize(model, 4)
    randomize_norms(model, 5)
    model = model.to(dev).eval()
    g = torch.Generator().manual_seed(1)
    wav = torch.randn(args.frames * crepe.HOP - crepe.HOP, generator=g)
    frames = crepe.frame_audio(wav.to(dev))[: args.chunk]
    variants = ("conv2d", "conv2d_bench", "conv1d", "conv1d_bench")
    torch.backends.cudnn.benchmark = False
    x = frames[:, None, :, None]
    with torch.no_grad():
        for i, (k, s) in enumerate(zip(crepe.KERNELS, crepe.STRIDES), 1):
            layer = getattr(model, f"conv{i}")
            ref = conv(x, layer, k, s, "conv2d")
            flops = 2.0 * ref.numel() * layer.weight.shape[1] * k
            for v in variants:
                torch.backends.cudnn.benchmark = v.endswith("bench")
                ms = ms_per_call(lambda: conv(x, layer, k, s, v))
                got = conv(x, layer, k, s, v)
                rel = float((got - ref).double().norm()
                            / ref.double().norm())
                print(f"layer {i} (C_in {x.shape[1]}, C_out "
                      f"{ref.shape[1]}, T {ref.shape[2]}, k {k}) {v}: "
                      f"{ms:.3f} ms, {flops / ms / 1e9:.2f} TFLOP/s, rel_l2 "
                      f"{rel:.2e}")
            x = getattr(model, f"conv{i}_BN")(F.relu(ref))
            x = F.max_pool2d(x, (2, 1), (2, 1))
    del held
    return 0


def full_model_first(args, dev):
    """The whole network before any per-layer timing (which would fill
    cuDNN's algorithm cache for the 512-frame shapes): as shipped, then
    with the benchmark held off."""
    model = crepe.Crepe()
    randomize(model, 4)
    randomize_norms(model, 5)
    model = model.to(dev).eval()
    g = torch.Generator().manual_seed(2)
    wav = torch.randn(args.frames * crepe.HOP - crepe.HOP, generator=g)
    full = crepe.frame_audio(wav.to(dev))
    saved = crepe.cudnn_benchmark
    if args.heuristic:
        crepe.cudnn_benchmark = crepe.contextlib.nullcontext
    try:
        ms = ms_per_call(lambda: crepe.posteriors(model, full), reps=2)
    finally:
        crepe.cudnn_benchmark = saved
    free = torch.cuda.mem_get_info()[0] / 2 ** 30
    label = "heuristic (benchmark off)" if args.heuristic \
        else "as shipped (benchmark)"
    print(f"network on {full.shape[0]} frames, {label}: {ms:.1f} ms "
          f"({free:.1f} GiB free, {args.hold_gib:g} GiB held)")


if __name__ == "__main__":
    sys.exit(main())
