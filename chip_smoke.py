#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (diffsvc_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

(``--deterministic-step BUNDLE`` is phase 5's child process, below.)

Phases, in order; any failure exits non-zero and no result line is printed:

1. The card: ``nvidia-smi`` name and power limit; CUDA is required (there
   is no CPU fallback); TF32 is turned off for cuDNN and matmuls, so every
   f32 product PyTorch computes (the plain versions, cuDNN's convolutions)
   is true f32.  The port's own f32 K1, K2 (the denoiser's residual
   layers and its input, skip and output projections inside the ladder),
   K3 (the vocoder tail), K4's f32 stream, K5 (the training stack) and K6
   (the single residual layer) are no longer pure f32: they multiply on
   the tensor cores as 3xTF32 split products, good to ~2^-21 relative, and
   are held against those true-f32 plain versions at their f32 limits.
2. Build the hand-written kernels from ``diffsvc_tpu_torch/csrc`` (timed).
3. Kernel vs plain PyTorch version on the card, at the main path's shapes
   (T=1024, C=384, L=20, M=128, H=256; the vocoder tail at the openvpi
   geometry on 5 s of 44.1 kHz audio; K4 at the training shape B=24; K5 at
   B=32, a per-sample shape; K6, one layer, at B=1 and dilations 1-8; K2
   and K3 again at B=4, the batched serving routes' B; K1 and K2 at
   config_24k's widths, C=256 and M=80, and K3 at its HiFi-GAN V1 on 5 s of
   24 kHz audio), in f32 and bf16 for
   K1/K2/K4/K6 and f32 for K3/K5: relative-L2 and max-abs error (K4/K5: of
   the forward and each of the seven grads), both times (CUDA events, in
   turns) and the bound (the larger of the FLOPs over the operand type's
   peak and the bytes over the memory rate).  K5's batch must equal the
   in-order sum of its B=1 runs bit for bit, and is printed against K4 at
   the f32 stream.  Each tolerance must also be exceeded by the same kernel
   fed inputs that stand for a known bug (a planted fault: K1's last
   conditioner dropped; K2's skip-projection bias dropped, or its history
   not pushed; at f32, K1's, K2's and K3's weights split with their lo
   planes zeroed, so the a_hi b_lo products drop out of the 3xTF32 sums;
   K3's last NSF injection dropped; K4's and K5's last sample's cotangent
   dropped, K4's layer or K5's sample with the next one's saved x, and at
   f32 their weights split with zero lo planes; K6's taps read at 2d, and
   at f32 its weights split with zero lo planes), so a check that cannot
   see a wrong kernel fails (K1 keeps its packed weights per weight tensor
   and version, so its lo-planes fault runs on copies of the weights; its
   repeated calls must pack nothing, and a first call, which packs, is
   timed beside them).  Beside K1 bf16, cuBLAS's time for the same
   products alone (``torch.matmul``, the gate and output GEMM of each
   layer, no gather and no epilogue) as a diagnostic floor, which the port
   never calls; for K1 and K2 in both dtypes, their device time by kernel
   and their tensor-core plan's CTAs per layer launch; for K3, its device
   time by kernel (one template instance per stage), its launches per tail,
   the tail with every ResBlock1 pair as two conv launches (the path fuses
   the pairs of the narrow stages), and per stage the launch plans (CTAs,
   shared memory) and one k=11 conv against one true-f32 ``F.conv1d`` of
   the same shape (the library call); for K4 and K5, their device time by
   kernel; for K6, its device time by kernel (which must show its
   tensor-core kernels and no SIMT layer kernel), and its weight pack's
   time apart, beside a first call, which packs.  The f32 tensor-core rows'
   bound is the tensor cores' at 3xTF32 (495 TFLOP/s over three passes);
   the CUDA cores' f32 bound is printed beside it.
4. The slice: reference-format checkpoints with random weights from a seed
   at the full ``configs/config_44k.yaml`` widths (diffusion ckpt, HuBERT-
   soft .pt 768x12, NSF-HiFiGAN generator + config.json) in a temporary
   directory; the port's ``Svc`` + ``run_clip`` convert three voiced clips
   of 6.5-14 s with silences, once with ``diff_compute_dtype: bfloat16`` and
   once in f32.  Every kernel's launch counter is reset before and read
   after that run and must be nonzero; K1's and K2's bf16 tensor-core
   counters (``launches_tc``) must move on the bf16 conversions and stay 0
   on the f32 ones, and their 3xTF32 counters (``launches_tf32x3``) the
   reverse;
   outputs must have the input's length, be finite and non-silent; a short
   clip converted on the card must agree with the same conversion on the
   CPU (the plain path), in f32 and in bf16, and the card's conversion with
   a planted fault must not.  Where the time goes: ``torch.profiler`` over
   one ``run_clip`` of the 14 s clip per dtype (wall, device busy share,
   the top kernels); the bf16 one must run K1's tensor-core kernels and no
   SIMT layer kernel instantiated for bf16 operands, the f32 one K1's
   3xTF32 kernels and no SIMT layer kernel at all, and both K3's
   tensor-core conv kernels and no SIMT ``conv1d_kernel``; the conversions
   of each dtype must move K3's counter.
5. The training path at the same widths (``diffnet_train_stream_dtype``
   bf16, ``max_sentences`` 24): 32 synthetic clips of 4-12 s binarized by
   the port's binarizer (HuBERT-soft on the card), then ``run.py``'s
   ``run_task`` for 6 steps with validation and a checkpoint every 3 (K4's
   counter reset before and read after: it must be nonzero; the losses
   finite, the first in 0.5-2.0); a restart from the step-3 checkpoint must
   restore params and optimizer state bit for bit and train on to step 6;
   one step run twice from the same state, batch, t and noise under
   ``torch.use_deterministic_algorithms`` must give identical params (in a
   child process: only it sets the ``CUBLAS_WORKSPACE_CONFIG`` that cuBLAS
   needs for that mode, so phases 3-6 time cuBLAS as it is set up by
   default); one
   step through the kernels must agree with the same step through the plain
   versions on the card, and a planted fault must not; ms per step,
   samples/s and mel frames/s for both stream dtypes, with the route each
   takes (the f32 stream's batch of 24 exceeds K4's carry: K5); a profile
   of one step, which must run K4 on the tensor cores (the bf16 kernels of
   its forward and backward) and none of the SIMT training kernels; and
   the step-6 checkpoint converts a clip through ``Svc``.
6. Training at config_44k's own batching (``max_sentences`` 88,
   ``max_tokens`` 128000, bf16 stream): 96 clips of 4-8 s binarized by the
   port (8 held out for validation), ``run_task`` for 3 steps; every batch
   is printed with B, T and its route, and the batch of 88 must take the
   per-sample route: K5's counter (reset before, read after) must equal the
   steps, K4's backward must not move, validation (B=1) runs K1; ms/step,
   samples/s, mel frames/s and peak memory at B=88; a profile of one step,
   which must run K5 on the 3xTF32 tensor-core kernels and none of the
   SIMT training kernels; one step through the kernels against the plain
   versions on the card, with a planted fault.
7. Serving on phase 4's project and its 14 s clip (``[serve]`` lines):
   ``run_clip(fused=True)`` in bf16 and f32, where each length bucket is
   captured once as a CUDA graph and a replay must equal the same body run
   eagerly on the card bit for bit; a 0.5 s fused conversion on the card
   against the same one on the CPU at phase 4's limits (and the skip-bias
   fault above them); a profile of one fused chunk, in which no
   device-to-host copy may start before its last kernel; per route
   (modular ``Svc.infer``, fused eager, fused graph, batched
   ``--batch_chunks``) the wall, RTF, device busy share and graph memory;
   a 17 s clip whose three voiced chunks the collate pads to one length,
   where the batched route must run K2 and K3 once per conversion at B=3,
   and ``FusedSvc.batched`` at B=3 against each chunk's B=1 call on the
   same padding and noise (1e-4 at f32); the
   server (``diffsvc_tpu_torch.flask_api``) in this process on 127.0.0.1:
   three fused and three streamed requests answered 200 with the posted
   duration, a malformed one 400.  K2's and K3's counters, reset before
   each of these, must move in each.
8. The rest of conversion (``[rest]`` lines; every counter reset before
   each route and read after it):
   (a) DDPM (``acc=1``, 1000 steps) on phase 4's project: a 3 s voiced
   clip through ``run_clip``, modular and fused graph, in bf16 and f32 (the
   output's length, finite, non-silent; K1's counter a whole number of
   1000-step trajectories, at least one per chunk, and K2's 0); the
   sampler alone timed and profiled (ms, launches and device ms per step),
   a fused chunk's replay per step, the acc=1 bucket's warm-up, capture
   and pool; a 0.5 s conversion card vs CPU with ``use_gt_mel`` at 50 steps
   and the per-step noise shared, at phase 4's limits, the skip-bias fault
   above them.
   (b) CREPE (random weights in torchcrepe's ``full.pth`` layout): the 14 s
   clip through ``get_pitch`` on the card (tracker ``crepe``), the network
   and the Viterbi timed apart; its posteriors card vs CPU on a block of
   128 frames (rel-L2 <= 1e-4, both true f32) and the share of frames
   whose decoded f0 agrees; the binarizer on config_44k as shipped
   (``use_crepe: true``) on 6 clips, every item tracked by CREPE with
   weights and by the AC tracker without.
   (c) A config_24k project at full width (DiffNet 256 x 20, 80 mel,
   HuBERT-soft 768 x 12, pe, HiFi-GAN V1 512 / rates 8, 8, 2, ContentVec
   768 x 12): the 14 s clip at 24 kHz through the modular and batched
   routes (with pe) and the fused graph, bf16 and f32, K2 and K3 moving on
   each; wall, RTF and busy share per route; card vs CPU at phase 4's
   limits with the fault; pe's time and its card-vs-CPU agreement
   (1e-4); ContentVec's encode beside HuBERT-soft's and one conversion
   through it.
9. The rest of single-card training and the data inventory (``[train2]``
   lines; K1-K5's counters reset before each part and read after it, K6's
   rise read over it; each part's counts go into the kernels line), on
   phase 5's binarized data and checkpoint:
   (a) ``optimizer: radam`` through ``run_task`` for 7 steps at phase 5's
   batching (K4 must move, and K1 once per validation batch, validation's
   loss; K2, K3, K5 and K6 not; steps 6 and 7 take RAdam's rectified
   branch): finite losses; the port's update on the card against
   optax's update written out on the card over steps 1-7 (rel-L2 <= 1e-6;
   the rectification dropped must read above it); a restart from step 3
   restoring params and RAdam's state bit for bit; ms per step.
   (b) The pe task at config_24k's pe width (hidden 256, 2 conv layers, 80
   mel): 16 clips binarized at 24 kHz, ``run_task`` with the pe
   ``task_cls`` (finite losses; no kernel launched), one step on the card
   and on the CPU, each against the same step in float64 on the CPU: the
   card's loss, and the loss and each parameter's grad of pe's smooth
   twin (ReLU as softplus, see ``PE_STEP_TOL``), rel-L2 <= 1e-4, the
   card's step under PyTorch's default ``cudnn.allow_tf32``; the
   convolutions left at TF32 must read above it; the ReLU model's grads
   printed, card and CPU; the step's time; the trained checkpoint as a
   config_24k ``Svc``'s ``pe_ckpt`` (``svc.pe`` set, its weights equal)
   converting the 14 s clip with ``use_pe`` (K2 and K3 moving).
   (c) ``--infer`` on phase 5's step-6 checkpoint: a ``[P]`` wav, png (where
   matplotlib is installed) and npy per test item, each wav finite and
   non-silent, each mel inside
   [mel_vmin, mel_vmax]; K2's counter equal to the test items and K3's to
   the wavs rendered, K4, K5 and K6 not moving; seconds per item.
   (d) The binarizer on phase 5's 32 clips (AC tracker) with
   ``binarize_batch_size`` 8 and 1 (no kernel launched): items/s of
   each; per item the batched
   result against the per-item one at JAX's own test tolerances (mel
   rtol 1e-5 / atol 1e-6, f0 rtol 1e-4 / atol 1e-3, mel2ph and len equal,
   units of equal shape; the units' rel-L2 printed, not gated); the f0
   cache on the per-item path: a first run with ``f0_cache_dir`` tracks
   and writes every item, a second one tracks none.

The line before the last is the card's ``nvidia-smi`` name and power limit,
preceded by one JSON line describing every kernel (K1-K6: its launches on
the path that runs it, on each serving route, on each of phase 8's routes
and in each of phase 9's parts, errors, times, bound);
the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Relative-L2 tolerances and why.  Each sits between the sound reading on the
# H100 and the reading of the planted faults (both printed each run).
TOL = {
    # one K1 call, 20 layers: 3xTF32 products (each good to ~2^-21) summed
    # in another order than the plain version's true-f32 ones
    ("residual_stack", "f32"): 1e-5,
    # bf16 operands: kernel and plain round the same values to bf16, but a
    # different f32 sum can flip a rounding of x/h, which then propagates
    ("residual_stack", "bf16"): 1e-2,
    # the ladder is compared on the part of the final state that the
    # denoiser put there: x_final minus the same ladder run with eps = 0
    # (the plain version with W_out, b_out zeroed).  The sampler update is
    # linear in the evaluations' eps, so this is their weighted error; on
    # x_final itself eps is ~4% of the state and a fault hides behind the
    # noise term.  51 evaluations x 20 layers, f32 state in both; at f32
    # the kernels' products are 3xTF32.
    ("plms_ladder", "f32"): 1e-4,
    ("plms_ladder", "bf16"): 1e-2,
    # ~60 f32 convolutions of the tail
    ("vocoder_tail", "f32"): 1e-4,
    # K4 forward + backward at B=24, T=1024, C=384, L=20: the largest rel-L2
    # over the skip sum and the seven grads.  f32: 3xTF32 products (each
    # good to ~2^-21) summed in another order than the plain version's
    # true-f32 ones (sound 1.2e-6 on the H100).  bf16 streams: kernel and
    # plain round y, h, do and dz at the same points, but another f32 sum
    # can flip a rounding (sound 3.1e-3).  The planted faults read 0.21 (the
    # last sample's cotangent dropped) and 0.10 (one layer's saved x taken
    # from the next layer) in both dtypes; at f32 the weights' lo planes
    # zeroed must read above the limit too.
    ("residual_stack_train_batched", "f32"): 1e-5,
    ("residual_stack_train_batched", "bf16"): 1e-2,
    # K5 (K4's forward at the f32 stream, the per-sample backward) at B=32,
    # T=1024, C=384, L=20, a per-sample shape in JAX: the largest rel-L2 over
    # the skip sum and the seven grads; 3xTF32 products against the plain
    # per-sample loop's true-f32 ones, summed in another order (sound 8.2e-7
    # on the H100; the planted faults read 0.18, the last sample's cotangent
    # dropped, and 0.16, one sample's saved x taken from the next sample;
    # the weights' lo planes zeroed must read above the limit too).
    ("residual_stack_train", "f32"): 1e-5,
    # K6, one layer at B=1, T=1024, C=384, dilations 1, 2, 4, 8: the largest
    # rel-L2 over x' and skip.  f32: one layer's 3xTF32 products against the
    # plain version's true-f32 ones (sound 5.2e-7 on the H100); bf16: the
    # same roundings, a few flipped by the tensor cores' f32 sums (sound
    # 1.9e-4).  The taps read at 2d read 0.68 in both dtypes; at f32 the
    # weights' lo planes zeroed read 3.1e-4.
    ("fused_residual_block", "f32"): 1e-5,
    ("fused_residual_block", "bf16"): 1e-3,
}
# f32 conversion of a short clip, card vs CPU: relative L2 of the waveform's
# part that the denoiser put there (see cpu_agreement).  The planted fault
# is the card's denoiser with its skip-projection bias dropped.
SLICE_TOL = 1e-2
# The same at diff_compute_dtype bfloat16: card and CPU round the same
# values to bf16, but their f32 sums differ in order, so a few roundings
# of x and h flip and propagate through 51 evaluations x 20 layers (the
# kernel checks' bf16 limit is 1e-2 on one call); the vocoder stays f32.
SLICE_TOL_BF16 = 2e-2
KERNELS = {
    "residual_stack": ("diffsvc_tpu_torch/csrc/diffnet_stack.cu",
                       "diffsvc_tpu/ops/pallas/diffnet_stack.py:129"),
    "plms_ladder": ("diffsvc_tpu_torch/csrc/plms_ladder.cu",
                    "diffsvc_tpu/ops/pallas/plms_ladder.py:196"),
    "vocoder_tail": ("diffsvc_tpu_torch/csrc/vocoder_tail.cu",
                     "diffsvc_tpu/ops/pallas/vocoder_tail.py:348"),
    # backward _call_bwd_batched; its forward is _call_fwd (:338)
    "residual_stack_train_batched": (
        "diffsvc_tpu_torch/csrc/diffnet_stack_train.cu",
        "diffsvc_tpu/ops/pallas/diffnet_stack.py:606"),
    # backward _call_bwd, vmapped; its forward is K4's (_call_fwd)
    "residual_stack_train": (
        "diffsvc_tpu_torch/csrc/diffnet_stack_per_sample.cu",
        "diffsvc_tpu/ops/pallas/diffnet_stack.py:378"),
    # on no path of the JAX package: launched by phase 3 alone
    "fused_residual_block": ("diffsvc_tpu_torch/csrc/diffnet_block.cu",
                             "diffsvc_tpu/ops/pallas/diffnet_block.py:93"),
}
# Published dense peaks of one H100 SXM (NVIDIA's data sheet): FLOP/s by
# operand type (f32 outside the tensor cores) and device-memory bytes/s.
# "tf32x3": f32 products as three TF32 passes on the tensor cores (495
# TFLOP/s dense TF32 over 3), the rate K1's and K2's f32 kernels run at.
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32x3": 495e12 / 3}
PEAK_BYTES = 3.35e12
# main-path shapes at config_44k: frames, residual channels, layers, mel
# bins, conditioner width
T, C, L, M, H = 1024, 384, 20, 128, 256
# (residual channels, mel bins) of each profile: config_44k's, and
# config_24k's (DiffNet 256 x 20, 80 mel; the same frames and layers)
GEOS = {"44k": (C, M), "24k": (256, 80)}
# openvpi 44.1 kHz NSF-HiFiGAN geometry
VOC_H = dict(num_mels=128, upsample_initial_channel=512,
             upsample_rates=[8, 8, 2, 2, 2],
             upsample_kernel_sizes=[16, 16, 4, 4, 4], resblock="1",
             resblock_kernel_sizes=[3, 7, 11],
             resblock_dilation_sizes=[[1, 3, 5]] * 3, sampling_rate=44100,
             n_fft=2048, win_size=2048, hop_size=512, fmin=40, fmax=16000)
TAIL_FRAMES = 431           # 5.0 s of 44.1 kHz audio
# config_24k's HiFi-GAN V1 (0109_hifigan_bigpopcs_hop128's geometry): 512
# initial channels, rates 8, 8, 2 (= hop 128), K3 from its 128-channel stage
VOC24_H = dict(num_mels=80, upsample_initial_channel=512,
               upsample_rates=[8, 8, 2], upsample_kernel_sizes=[16, 16, 4],
               resblock="1", resblock_kernel_sizes=[3, 7, 11],
               resblock_dilation_sizes=[[1, 3, 5]] * 3, sampling_rate=24000,
               n_fft=512, win_size=512, hop_size=128, fmin=30, fmax=12000)
TAIL_FRAMES_24K = 938       # 5.0 s of 24 kHz audio at hop 128
TRAIN_B = 24                # the training batch (max_sentences) of K4's check
PS_B = 32                   # K5's check: per-sample in JAX at T=1024 (f32)
DILATIONS = (1, 2, 4, 8)    # K6's check
# (seconds, f0 Hz, silent spans) of the slice's clips
CLIPS = [(6.5, 196.0, [(2.0, 2.6)]),
         (9.0, 262.0, [(5.5, 6.4)]),
         (14.0, 330.0, [(6.0, 7.0), (12.3, 12.6)])]
ACC = 20
SERVE_B = 4      # phase 3's K2 and K3 at the batched serving routes' B


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back runs (CUDA
    events around the whole run; one warm-up run first)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_in_turns(kern, plain, reps: int):
    """(kernel ms, plain ms), each the mean of two measurements taken in
    the order plain, kernel, kernel, plain, so drift on the card (clocks,
    power) falls on both sides alike."""
    p1 = cuda_time_ms(plain, reps)
    k1 = cuda_time_ms(kern, reps)
    k2 = cuda_time_ms(kern, reps)
    p2 = cuda_time_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _dtype(name):
    import torch

    return torch.bfloat16 if name == "bf16" else torch.float32


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, moved: int, rate: str) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak rate ``PEAK_FLOPS[rate]`` and the bytes (each input read
    once, each output written once) over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[rate], moved / PEAK_BYTES
    return {"flops": flops, "bytes": moved, "bound_ms": max(t_ops, t_bytes)
            * 1e3, "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def tc_bound(flops: float, moved: int, dtype_name: str) -> dict:
    """The tensor-core kernels' bound at the rate they run (bf16 or 3xTF32
    tensor cores), with the CUDA cores' f32 bound beside it at f32."""
    res = bound(flops, moved, "tf32x3" if dtype_name == "f32" else "bf16")
    if dtype_name == "f32":
        res["cuda_core_bound_ms"] = bound(flops, moved, "f32")["bound_ms"]
    return res


@contextlib.contextmanager
def lo_planes_dropped():
    """K1's and K2's f32 weights split with zero lo planes (a planted
    fault: the a_hi b_lo products drop out of the 3xTF32 sums)."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds

    split = ds.split_tf32

    def hi_only(a):
        hi, lo = split(a)
        return hi, lo.zero_()

    with swapped(ds, split_tf32=hi_only):
        yield


def plan_ctas(dtype_name: str, m: int = 0, c: int = C) -> dict:
    """K1's (or K2's, m > 0) tensor-core plan at B=1 for the collate's
    frame counts: CTAs and shared memory per layer launch, and for K2 the
    CTAs of its projections."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds

    out = {}
    for t in (512, 768, 1024):
        p = ds.tc_plan(1, t, c, m, _dtype(dtype_name))
        out[t] = {"ctas_layer": p.ctas_layer, "smem_layer": p.smem_layer}
        if m:
            out[t]["ctas_in"] = p.grid_m * p.grid_n_in
            out[t]["ctas_epi"] = p.grid_m * (
                1 if dtype_name == "bf16" else p.mp // p.bn)
    return out


def stack_flops(rows: int, layers: int, per_row: int, c: int = C) -> float:
    """``per_row`` c^2 FLOPs per row and layer: 16 for a forward layer
    (gate 12 + output 4), 60 for forward and backward (the backward's
    recomputed gate 12, dh 4, dy 12, dWo 4, dW_j 12)."""
    return float(per_row) * rows * c * c * layers


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_residual_stack(device, dtype_name, geo="44k"):
    """K1 at B=1, T=1024, L=20 and ``geo``'s channels.  Its packed weights
    are kept per weight tensor and version: the times are repeated calls
    (which must pack nothing), beside a first call, which packs; the f32
    fault "lo planes zeroed" reaches the kernel through copies of the
    weights (the originals' packs are kept)."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    c = GEOS[geo][0]
    a = stack_inputs(_dtype(dtype_name), device, 1, T, c, L)
    kern = lambda: ds.residual_stack(**a, cycle=4)              # noqa: E731
    plain = lambda: ds.residual_stack_plain(**a, cycle=4)       # noqa: E731
    got, ref = kern(), plain()
    cp = a["cond_proj"].clone()
    cp[-1] = 0
    faults = {"cond dropped": dict(a, cond_proj=cp),
              "sb shifted by one layer": dict(a, sb=a["sb"].roll(1, 0))}
    fault_rel = {k: rel_l2(ds.residual_stack(**f, cycle=4), ref)
                 for k, f in faults.items()}
    if dtype_name == "f32":
        copies = dict(a, wd=a["wd"].clone(), wo=a["wo"].clone())
        with lo_planes_dropped():
            fault_rel["lo products dropped"] = rel_l2(
                ds.residual_stack(**copies, cycle=4), ref)
        del copies
    packs = ds.packs
    ms, plain_ms = time_in_turns(kern, plain, reps=10)
    if ds.packs != packs:
        raise SmokeError(f"residual_stack {dtype_name} {geo}: repeated calls "
                         f"packed the weights {ds.packs - packs} times")

    def first_call():
        ds._packed.clear()
        kern()

    res = {"max_abs_err": float((got - ref).abs().max()),
           "rel_l2": rel_l2(got, ref), "fault_rel_l2": fault_rel,
           "ms": ms, "plain_ms": plain_ms,
           "first_call_ms": cuda_time_ms(first_call, reps=5),
           **tc_bound(stack_flops(T, L, 16, c), nbytes(*a.values(), got),
                      dtype_name)}
    res["breakdown"] = kernel_breakdown(kern, reps=5)
    res["plan"] = plan_ctas(dtype_name, c=c)
    if dtype_name == "bf16" and geo == "44k":
        res["cublas_products_ms"] = cublas_products_ms(a)
    return res


def kernel_breakdown(fn, reps: int) -> dict:
    """Device time per call of ``fn`` by kernel (torch.profiler over
    ``reps`` calls after a warm-up): {name: [ms per call, launches per
    call]}, the name cut at its argument list and to 60 characters."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    # a trace of a short run can come back with no device event at all
    # (seen once on the H100 over K6's 5 calls of 0.1 ms); such a trace is
    # taken again, up to twice, and a trace with events is read as it is
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = e.name.replace("(anonymous namespace)::", "")
                tot = out.setdefault(name.split("(")[0][:60], [0.0, 0])
                tot[0] += (e.time_range.end - e.time_range.start) / 1e3 / reps
                tot[1] += 1
        if out:
            break
        log(f"[profile] trace {attempt + 1} holds no device event")
    return {k: [ms, n / reps] for k, (ms, n) in
            sorted(out.items(), key=lambda kv: -kv[1][0])}


def cublas_products_ms(a) -> float:
    """cuBLAS's time for K1's products alone at bf16 (``torch.matmul``:
    per layer the gate GEMM [T, 3C] x [3C, 2C] and the output GEMM [T, C] x
    [C, 2C]; no tap gather, no epilogue): a diagnostic floor for products of
    this size, not a computation of K1's function."""
    import torch

    y3 = torch.randn(T, 3 * C, device=a["x0"].device).to(torch.bfloat16)
    h = y3[:, :C].contiguous()
    wd = a["wd"].reshape(L, 3 * C, 2 * C)

    def run():
        for layer in range(L):
            torch.matmul(y3, wd[layer])
            torch.matmul(h, a["wo"][layer])

    return cuda_time_ms(run, reps=10)


def ladder_inputs(dtype, device, batch: int = 1, c: int = C, m: int = M):
    """A DiffNet at ``c`` residual channels and ``m`` mel bins (the main
    path's by default) with torch's default init drawn from seed 0 (the
    reference, and DiffNet's own init, zero the output projection, which
    would make eps == 0 and the comparison vacuous) and the K=1000 PLMS
    acc=20 tables: J = 51 evaluations; ``batch`` clips."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.models import diffnet
    from diffsvc_tpu_torch.models.diffusion import make_tables
    from diffsvc_tpu_torch.ops.hopper import plms_ladder as pl
    from diffsvc_tpu_torch.utils.synth import randomize

    net = diffnet.DiffNet(m, H, L, c, 4)
    randomize(net, 0)
    net = net.to(device)
    p = net.stacked(dtype)
    ac = make_tables(1000, "linear", 0.02)["alphas_cumprod"]
    t_eval, scal = pl.plms_eval_tables(ac, 1000, ACC)
    step = diffnet.step_embedding(p, torch.from_numpy(t_eval).to(device), c)
    sb = diffnet.step_bias(p, step, dtype).transpose(0, 1).contiguous()
    g = torch.Generator().manual_seed(1)
    cond = (torch.randn(batch, T, H, generator=g) * 0.5).to(device)
    cp = diffnet.prepare_cond(net, cond).to(dtype).contiguous()
    x = torch.randn(batch, T, m, generator=g).to(device)
    return dict(x_init=x, scal=torch.from_numpy(np.ascontiguousarray(scal)).to(device),
                sb_tab=sb, cond_proj=cp, win=p["win"], bin_=p["bin"],
                wskip=p["wskip"], bskip=p["bskip"], wout=p["wout"],
                bout=p["bout"], wd=p["wd"], bd=p["bd"], wo=p["wo"],
                bo=p["bo"])


def check_plms_ladder(device, dtype_name, batch: int = 1, geo="44k"):
    import torch

    from diffsvc_tpu_torch.ops.hopper import plms_ladder as pl

    c, m = GEOS[geo]
    a = ladder_inputs(_dtype(dtype_name), device, batch, c, m)
    kern = lambda: pl.plms_ladder(**a, cycle=4)                 # noqa: E731
    plain = lambda: pl.plms_ladder_plain(**a, cycle=4)          # noqa: E731
    got, ref = kern(), plain()
    base = pl.plms_ladder_plain(**dict(a, wout=torch.zeros_like(a["wout"]),
                                       bout=torch.zeros_like(a["bout"])),
                                cycle=4)
    no_push = a["scal"].clone()
    no_push[:, pl.NS - 1] = 0
    faults = {"bskip dropped": dict(a, bskip=torch.zeros_like(a["bskip"])),
              "history not pushed": dict(a, scal=no_push)}
    fault_rel = {k: rel_l2(pl.plms_ladder(**f, cycle=4) - base, ref - base)
                 for k, f in faults.items()}
    if dtype_name == "f32":
        with lo_planes_dropped():
            fault_rel["lo products dropped"] = rel_l2(kern() - base,
                                                      ref - base)
    ms, plain_ms = time_in_turns(kern, plain, reps=2)
    extra = {} if batch > 1 else {
        "breakdown": kernel_breakdown(kern, reps=1),
        "plan": plan_ctas(dtype_name, m, c)}
    return {**extra, "batch": batch,
            "max_abs_err": float((got - ref).abs().max()),
            "rel_l2": rel_l2(got - base, ref - base),
            "final_x_rel_l2": rel_l2(got, ref),
            "eps_share": rel_l2(ref, base), "fault_rel_l2": fault_rel,
            "evals": int(a["scal"].shape[0]), "ms": ms, "plain_ms": plain_ms,
            **tc_bound(int(a["scal"].shape[0]) * batch * (
                stack_flops(T, L, 16, c) + 2.0 * T * (2 * m * c + c * c)),
                       nbytes(*a.values(), got), dtype_name)}


def check_vocoder_tail(device, dtype_name, batch: int = 1, geo="44k"):
    """The generator tail's inputs at the openvpi geometry on 5 s of 44.1
    kHz audio, or (``geo`` "24k") config_24k's HiFi-GAN V1 on 5 s of 24 kHz
    audio (``batch`` clips); the prologue and the NSF noise convs run in
    plain torch."""
    import math

    import torch

    from diffsvc_tpu_torch.ops.hopper import vocoder_tail as vt
    from diffsvc_tpu_torch.vocoders import generator as gen_mod

    voc_h, frames = (VOC_H, TAIL_FRAMES) if geo == "44k" \
        else (VOC24_H, TAIL_FRAMES_24K)
    torch.manual_seed(0)
    cfg = gen_mod.HifiGanConfig.from_dict(voc_h, use_nsf=True)
    gen = gen_mod.Generator(cfg).to(device).eval()
    g = torch.Generator().manual_seed(1)
    mel = (torch.randn(batch, frames, cfg.num_mels, generator=g) - 4.0
           ).to(device)
    f0 = (220.0 * 1.25 ** torch.arange(batch, dtype=torch.float32)[:, None]
          ).expand(batch, frames).contiguous().to(device)
    length = frames * int(math.prod(cfg.upsample_rates))
    randoms = gen_mod.draw_randoms(batch, length, cfg.harmonic_num, g)
    randoms = tuple(r.to(device) for r in randoms)
    s0 = gen_mod.tail_start_stage(cfg)
    with torch.no_grad():
        har = gen_mod.harmonic_source(gen, f0, randoms)
        x = gen_mod.tail_prologue(gen, mel, har, s0)
        injs = [gen.noise_convs[i](har).transpose(1, 2).contiguous()
                for i in range(s0 + 1, len(cfg.upsample_rates))]
        plan = gen.tail_plan(s0)
        kern = lambda: vt.tail(x, injs, plan)                   # noqa: E731
        plain = lambda: vt.tail_plain(x, injs, plan)            # noqa: E731
        # the same kernels with every ResBlock1 pair as two conv launches
        unfused = lambda: vt._run(plan, x, injs, vt._conv_kernel,  # noqa
                                  vt._convt_kernel)
        got, ref = kern(), plain()
        fault_rel = {
            "injection dropped": rel_l2(vt.tail(
                x, injs[:-1] + [torch.zeros_like(injs[-1])], plan), ref),
            "lo products dropped": rel_l2(vt.tail(
                x, injs, tail_lo_planes_dropped(plan)), ref)}
        ms, plain_ms = time_in_turns(kern, plain, reps=5)
        flops = tail_flops(vt, x, injs, plan)
        extra = {}
        if batch == 1:
            unfused_ms, fused_ms = time_in_turns(unfused, kern, reps=5)
            breakdown = kernel_breakdown(kern, reps=3)
            extra = {"breakdown": breakdown,
                     "pairs": {"unfused_ms": unfused_ms, "fused_ms": fused_ms,
                               "unfused_rel_l2": rel_l2(unfused(), ref),
                               "unfused_breakdown": kernel_breakdown(
                                   unfused, reps=3)},
                     "stages": tail_stages(vt, plan, x.shape, device),
                     "tail_launches": sum(n for _, n in breakdown.values())}
    weights = [t for cp in [plan.post] + [c for st in plan.stages for br in
                                          st.branches for c in br]
               for t in (cp.w_t, cp.b)]
    weights += [t for st in plan.stages if st.convt is not None
                for t in (st.convt.w_t, st.convt.b)]
    return {**extra, "batch": batch,
            "max_abs_err": float((got - ref).abs().max()),
            "rel_l2": rel_l2(got, ref), "fault_rel_l2": fault_rel,
            "samples": int(got.shape[1]), "ms": ms, "plain_ms": plain_ms,
            **tc_bound(flops, nbytes(x, *injs, *weights, got), dtype_name)}


def tail_lo_planes_dropped(plan):
    """K3's plan with every packed weight's lo plane zeroed (a planted
    fault: the a_hi b_lo products drop out of the 3xTF32 sums)."""
    def hi_only(cp):
        wp = cp.wp.clone()
        wp.select(-3, 1).zero_()
        return cp._replace(wp=wp)

    return plan._replace(
        post=hi_only(plan.post),
        stages=tuple(st._replace(
            convt=None if st.convt is None else hi_only(st.convt),
            branches=tuple(tuple(hi_only(cp) for cp in br)
                           for br in st.branches)) for st in plan.stages))


def tail_flops(vt, x, injs, plan) -> float:
    """The tail's convolution FLOPs, counted while its plain version walks
    the plan: 2 Cin Cout k per output sample of a conv, per input sample of
    a transposed conv."""
    total = [0.0]

    def conv(xx, cp, *args, **kw):
        cout, cin, k = cp.w_t.shape
        total[0] += 2.0 * xx.shape[0] * xx.shape[1] * cin * cout * k
        return vt._conv_plain(xx, cp, *args, **kw)

    def convt(xx, tp, *args, **kw):
        cin, cout, k = tp.w_t.shape
        total[0] += 2.0 * xx.shape[0] * xx.shape[1] * cin * cout * k
        return vt._convt_plain(xx, tp, *args, **kw)

    vt._run(plan, x, injs, conv, convt)
    return total[0]


def tail_stages(vt, plan, x_shape, device) -> list:
    """Per stage of the tail: the launch plans (CTAs, shared memory, N tile,
    rows per CTA) of its ConvT and convs, and one k=11 resblock conv
    (dilation 1) timed as K3 launches it against one true-f32 ``F.conv1d``
    of the same shape on the pre-activated input (the library call; the
    port never makes it), with that conv's bound at 3xTF32."""
    import torch
    import torch.nn.functional as F

    out = []
    _, t, c = x_shape
    g = torch.Generator().manual_seed(2)
    for i, st in enumerate(plan.stages):
        rec = {"stage": plan.s0 + i}
        if st.convt is not None:
            p = vt.convt_tile_plan((1, t, c), st.convt)
            rec["convt_plan"] = [p.ctas, p.smem, p.bn, p.bm]
            cin, c, k = st.convt.w_t.shape
            t = (t - 1) * st.convt.stride - 2 * st.convt.pad + k
        convs = [cp for br in st.branches for cp in br]
        rec.update(channels=c, rows=t, conv_plans=sorted(
            {(p.ctas, p.smem, p.bn, p.bm) for p in (
                vt.conv_tile_plan((1, t, c), cp) for cp in convs)}))
        if st.kind == "1":   # (k, d, CTAs, shared memory), or unfused
            rec["pair_plans"] = [
                (k, d) + ((pp.ctas, pp.smem) if pp else ("two launches",))
                for k, d, pp in sorted({(cp.w_t.shape[-1], cp.dilation,
                                         vt.pair_plan(1, t, c,
                                                      cp.w_t.shape[-1],
                                                      cp.dilation))
                                        for cp in convs[::2]})]
        cp = next(cp for cp in convs if cp.w_t.shape[-1] == 11
                  and cp.dilation == 1)
        x = torch.randn(1, t, c, generator=g).to(device)
        xc = F.leaky_relu(x, 0.1).transpose(1, 2).contiguous()
        kern = lambda: vt._conv_kernel(x, cp, 0.1)              # noqa: E731
        lib = lambda: F.conv1d(xc, cp.w_t, cp.b,                # noqa: E731
                               padding=cp.pad, dilation=cp.dilation)
        rec["k11_ms"], rec["k11_library_ms"] = time_in_turns(kern, lib, 20)
        rec["k11_rel_l2"] = rel_l2(kern(), lib().transpose(1, 2))
        rec["k11_bound_ms"] = bound(2.0 * t * c * c * 11, nbytes(
            x, cp.w_t, cp.b) + 4 * t * c, "tf32x3")["bound_ms"]
        out.append(rec)
    return out


def train_stack_inputs(device, dtype_name):
    """K4's operands at the training shape: f32 state and biases, cond /
    wd / wo in the stream dtype, and a skip cotangent in it."""
    import torch

    from diffsvc_tpu_torch.utils.synth import stack_inputs

    sd = _dtype(dtype_name)
    a = stack_inputs(torch.float32, device, TRAIN_B, T, C, L)
    for k in ("cond_proj", "wd", "wo"):
        a[k] = a[k].to(sd).contiguous()
    g = torch.Generator().manual_seed(5)
    dout = torch.randn(TRAIN_B, T, C, generator=g).to(device, sd)
    return a, dout


GRAD_NAMES = ("skip", "dx0", "dsb", "dcp", "dwd", "dbd", "dwo", "dbo")


def per_output(got, ref) -> dict:
    return {n: {"rel_l2": rel_l2(x, y), "max_abs_err": float((x - y).abs()
                                                             .max())}
            for n, x, y in zip(GRAD_NAMES, got, ref)}


def check_residual_stack_train_batched(device, dtype_name):
    """K4's forward with save and backward against their plain versions."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4

    a, dout = train_stack_inputs(device, dtype_name)
    ops = (a["sb"], a["cond_proj"], a["wd"], a["bd"], a["wo"])

    def kern(dout=dout, swap=None):
        skip, xsave = k4.residual_stack_train_fwd(**a, cycle=4)
        if swap is not None:
            xsave[swap] = xsave[swap + 1]
        return (skip, *k4.residual_stack_train_batched_bwd(xsave, *ops, dout,
                                                            cycle=4))

    def plain():
        skip, xsave = k4.residual_stack_train_fwd_plain(**a, cycle=4)
        return (skip, *k4.residual_stack_train_batched_bwd_plain(
            xsave, *ops, dout, cycle=4))

    got, ref = kern(), plain()
    per = per_output(got, ref)
    dropped = dout.clone()
    dropped[-1] = 0
    faults = {"last sample's cotangent dropped": kern(dout=dropped),
              f"layer {L // 2}'s saved x taken from layer {L // 2 + 1}":
              kern(swap=L // 2)}
    fault_rel = {k: max(rel_l2(x, y) for x, y in zip(f[1:], ref[1:]))
                 for k, f in faults.items()}
    del faults
    if dtype_name == "f32":
        fault_rel["lo products dropped"] = lo_fault_rel(kern, ref)
    ms, plain_ms = time_in_turns(kern, plain, reps=2)
    return {"max_abs_err": max(v["max_abs_err"] for v in per.values()),
            "rel_l2": max(v["rel_l2"] for v in per.values()),
            "per_output": per, "fault_rel_l2": fault_rel, "batch": TRAIN_B,
            "ms": ms, "plain_ms": plain_ms,
            "breakdown": kernel_breakdown(kern, reps=1),
            **tc_bound(stack_flops(TRAIN_B * T, L, 60),
                       nbytes(*a.values(), dout, *got), dtype_name)}


def lo_fault_rel(kern, ref) -> float:
    """The largest rel-L2 over the skip sum and the seven grads of the
    training kernels run with their f32 weights split with zero lo planes
    (a planted fault: the a_hi b_lo products of every weight product drop
    out of the 3xTF32 sums)."""
    with lo_planes_dropped():
        got = kern()
    return max(rel_l2(x, y) for x, y in zip(got, ref))


def check_residual_stack_train(device, dtype_name):
    """K5: K4's forward with save at the f32 stream and the per-sample
    backward against their plain versions at B=32, a batch JAX routes
    per-sample; the batch against the in-order sum of its B=1 runs (bit for
    bit); and K5 against K4 at the f32 stream on the same inputs."""
    import torch

    from diffsvc_tpu_torch.models.diffnet import train_route
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_per_sample as k5
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    route = train_route(L, 4, T, C, PS_B, dtype_name)
    if route != "per_sample":
        raise SmokeError(f"K5's check shape routes to {route}")
    a = stack_inputs(torch.float32, device, PS_B, T, C, L)
    g = torch.Generator().manual_seed(6)
    dout = torch.randn(PS_B, T, C, generator=g).to(device)
    ops = (a["sb"], a["cond_proj"], a["wd"], a["bd"], a["wo"])

    def kern(dout=dout, mix=None):
        skip, xsave = k4.residual_stack_train_fwd(**a, cycle=4)
        if mix is not None:
            xsave[:, mix] = xsave[:, mix + 1]
        return (skip, *k5.residual_stack_train_bwd(xsave, *ops, dout,
                                                   cycle=4))

    def plain():
        skip, xsave = k4.residual_stack_train_fwd_plain(**a, cycle=4)
        return (skip, *k5.residual_stack_train_bwd_plain(xsave, *ops, dout,
                                                         cycle=4))

    got, ref = kern(), plain()
    per = per_output(got, ref)
    dropped = dout.clone()
    dropped[-1] = 0
    mix = PS_B // 2
    faults = {"last sample's cotangent dropped": kern(dout=dropped),
              f"sample {mix}'s saved x taken from sample {mix + 1}":
              kern(mix=mix)}
    fault_rel = {k: max(rel_l2(x, y) for x, y in zip(f[1:], ref[1:]))
                 for k, f in faults.items()}
    del faults
    fault_rel["lo products dropped"] = lo_fault_rel(kern, ref)
    # the batch against its B=1 runs, and against K4 at the f32 stream
    _, xsave = k4.residual_stack_train_fwd(**a, cycle=4)
    full = got[1:]
    exact = True
    sums = [torch.zeros_like(x) for x in full[3:]]
    for i in range(PS_B):
        one = k5.residual_stack_train_bwd(
            xsave[:, i:i + 1].contiguous(), a["sb"][:, i:i + 1],
            a["cond_proj"][:, i:i + 1].contiguous(), a["wd"], a["bd"],
            a["wo"], dout[i:i + 1], cycle=4)
        exact = exact and torch.equal(full[0][i:i + 1], one[0]) \
            and torch.equal(full[1][:, i:i + 1], one[1]) \
            and torch.equal(full[2][:, i:i + 1], one[2])
        sums = [s + x for s, x in zip(sums, one[3:])]
    exact = exact and all(torch.equal(x, s) for x, s in zip(full[3:], sums))
    vs_k4 = per_output(got, (got[0], *k4.residual_stack_train_batched_bwd(
        xsave, *ops, dout, cycle=4)))
    ms, plain_ms = time_in_turns(kern, plain, reps=2)
    return {"max_abs_err": max(v["max_abs_err"] for v in per.values()),
            "rel_l2": max(v["rel_l2"] for v in per.values()),
            "per_output": per, "fault_rel_l2": fault_rel, "batch": PS_B,
            "route": route, "batch_is_sum_of_b1": bool(exact),
            "vs_k4_f32": {k: v["rel_l2"] for k, v in vs_k4.items()},
            "ms": ms, "plain_ms": plain_ms,
            "breakdown": kernel_breakdown(kern, reps=1),
            **tc_bound(stack_flops(PS_B * T, L, 60),
                       nbytes(*a.values(), dout, *got), dtype_name)}


# K6's kernels in its profile: y = x + step, the gate and the output
# projection on the tensor cores, by dtype; and the SIMT layer kernels it ran
# before (gate_kernel<T>, block_out_kernel), which no profile may show
K6_KERNELS = {"bf16": ("tc::y0_kernel", "tc::gate_tc_kernel",
                       "k6::block_out_tc_kernel"),
              "f32": ("tf32x3::y0_kernel", "tf32x3::gate_kernel",
                      "tf32x3::out_kernel")}
SIMT_LAYER = re.compile(r"\b(gate|out)_kernel<|\bblock_out_kernel\b")


def check_fused_residual_block(device, dtype_name):
    """K6 at B=1, T=1024, C=384 for each dilation of a cycle against its
    plain version.  Planted faults: the taps read at 2d and, at f32, the
    weights split with zero lo planes (for copies of the weights: K6 keeps
    its packed weights per weight tensor).  Times are per call (the four
    dilations' total over four) with the packed weights kept; beside them
    the pack alone and a first call, which packs.  Its device time by
    kernel must show its tensor-core kernels and no SIMT layer kernel."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_block as k6
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    a = stack_inputs(_dtype(dtype_name), device, 1, T, C, 1)
    args = (a["x0"], a["sb"][0].contiguous(), a["cond_proj"][0], a["wd"][0],
            a["bd"][0], a["wo"][0], a["bo"][0])
    n = len(DILATIONS)

    def run(fn, stretch=1, ops=args):
        return [fn(*ops, dilation=stretch * d) for d in DILATIONS]

    kern = lambda: run(k6.fused_residual_block)                 # noqa: E731
    plain = lambda: run(k6.fused_residual_block_plain)          # noqa: E731
    got, ref = kern(), plain()

    def fault(outs):
        return min(max(rel_l2(x, y) for x, y in zip(f, r))
                   for f, r in zip(outs, ref))

    fault_rel = {"taps read at 2d": fault(run(k6.fused_residual_block, 2))}
    if dtype_name == "f32":
        copies = tuple(w.clone() if i in (3, 5) else w
                       for i, w in enumerate(args))
        with lo_planes_dropped():
            fault_rel["lo products dropped"] = fault(
                run(k6.fused_residual_block, ops=copies))
        del copies
    pairs = [(x, y) for g, r in zip(got, ref) for x, y in zip(g, r)]
    ms, plain_ms = time_in_turns(kern, plain, reps=10)
    cp = ds.tc_plan(1, T, C, dtype=_dtype(dtype_name)).cp

    def first_call():
        k6._packed.clear()
        k6.fused_residual_block(*args, dilation=1)

    pack_ms = cuda_time_ms(lambda: k6.pack_weights(args[3], args[5], cp),
                           reps=10)
    first_ms = cuda_time_ms(first_call, reps=10)
    breakdown = {k: [v[0] / n, v[1] / n]
                 for k, v in kernel_breakdown(kern, reps=5).items()}
    simt = [k for k in breakdown if SIMT_LAYER.search(k)]
    missing = [k for k in K6_KERNELS[dtype_name]
               if not any(k in name for name in breakdown)]
    if simt or missing:
        raise SmokeError(f"fused_residual_block {dtype_name}: its profile "
                         f"lacks {missing} or runs SIMT kernels {simt}: "
                         f"{sorted(breakdown)}")
    return {"max_abs_err": max(float((x - y).abs().max()) for x, y in pairs),
            "rel_l2": max(rel_l2(x, y) for x, y in pairs),
            "fault_rel_l2": fault_rel, "ms": ms / n, "plain_ms": plain_ms / n,
            "pack_ms": pack_ms, "first_call_ms": first_ms,
            "breakdown": breakdown,
            **tc_bound(stack_flops(T, 1, 16), nbytes(*args, *got[0]),
                       dtype_name)}


# (kernel, dtype, check[, keyword arguments of a variant: "batch", the
# batched serving routes' B (phase 7); "geo", config_24k's widths (phase 8)])
CHECKS = [("residual_stack", "f32", check_residual_stack),
          ("residual_stack", "bf16", check_residual_stack),
          ("residual_stack", "f32", check_residual_stack, {"geo": "24k"}),
          ("residual_stack", "bf16", check_residual_stack, {"geo": "24k"}),
          ("plms_ladder", "f32", check_plms_ladder),
          ("plms_ladder", "bf16", check_plms_ladder),
          ("plms_ladder", "f32", check_plms_ladder, {"batch": SERVE_B}),
          ("plms_ladder", "bf16", check_plms_ladder, {"batch": SERVE_B}),
          ("plms_ladder", "f32", check_plms_ladder, {"geo": "24k"}),
          ("plms_ladder", "bf16", check_plms_ladder, {"geo": "24k"}),
          ("vocoder_tail", "f32", check_vocoder_tail),
          ("vocoder_tail", "f32", check_vocoder_tail, {"batch": SERVE_B}),
          ("vocoder_tail", "f32", check_vocoder_tail, {"geo": "24k"}),
          ("residual_stack_train_batched", "f32",
           check_residual_stack_train_batched),
          ("residual_stack_train_batched", "bf16",
           check_residual_stack_train_batched),
          ("residual_stack_train", "f32", check_residual_stack_train),
          ("fused_residual_block", "f32", check_fused_residual_block),
          ("fused_residual_block", "bf16", check_fused_residual_block)]


def phase_kernels(device):
    out = {}
    for name, dt, fn, *variant in CHECKS:
        kw = variant[0] if variant else {}
        res = fn(device, dt, **kw)
        tol = TOL[(name, dt)]
        res["tol_rel_l2"] = tol
        faults = " ".join(f"[{k}: {v:.3e}]"
                          for k, v in res["fault_rel_l2"].items())
        # recorded as e.g. "f32 B=4", "bf16 24k"
        dt = " ".join([dt] + [f"B={v}" if k == "batch" else str(v)
                              for k, v in kw.items()])
        log(f"[kernel] {name} {dt}: rel_l2={res['rel_l2']:.3e} (tol {tol:g}) "
            f"max_abs={res['max_abs_err']:.3e} kernel_ms={res['ms']:.3f} "
            f"plain_ms={res['plain_ms']:.3f} bound_ms={res['bound_ms']:.4f} "
            f"({res['bound_by']}); planted faults {faults}")
        if "cublas_products_ms" in res:
            log(f"[kernel] {name} {dt}: cuBLAS alone on the same products "
                f"(torch.matmul, gate + output GEMM x {L} layers, no gather, "
                f"no epilogue; diagnostic floor, not library_ms): "
                f"{res['cublas_products_ms']:.3f} ms")
        if "cuda_core_bound_ms" in res:
            log(f"[kernel] {name} {dt}: bound {res['bound_ms']:.4f} ms at "
                f"3xTF32 on the tensor cores; {res['cuda_core_bound_ms']:.4f}"
                " ms at the CUDA cores' f32 rate")
        if name == "residual_stack":
            log(f"[kernel] {name} {dt}: packed weights kept per weight "
                f"tensor and version: a repeated call {res['ms']:.4f} ms "
                "(no pack); a first call, which packs, "
                f"{res['first_call_ms']:.4f} ms")
        if "pack_ms" in res:
            log(f"[kernel] {name} {dt}: packed weights kept per weight "
                f"tensor: a call {res['ms']:.4f} ms; a first call, which "
                f"packs, {res['first_call_ms']:.4f} ms; the pack alone "
                f"{res['pack_ms']:.4f} ms")
        if "plan" in res:
            log(f"[kernel] {name} {dt}: tensor-core plan at B=1: " + ", ".join(
                f"T={t}: " + " ".join(f"{k}={v}" for k, v in p.items())
                for t, p in res["plan"].items()))
        if "breakdown" in res:
            log(f"[kernel] {name} {dt} device ms per call by kernel: " +
                "; ".join(f"{k} {v[0]:.4f} ({v[1]:g}x)"
                          for k, v in list(res["breakdown"].items())[:16]))
        if "pairs" in res:
            pr = res["pairs"]
            log(f"[kernel] {name} {dt}: ResBlock1 pairs fused where they fit "
                f"(the path) {pr['fused_ms']:.3f} ms, each pair as two conv "
                f"launches {pr['unfused_ms']:.3f} ms (rel_l2 "
                f"{pr['unfused_rel_l2']:.3e}); unfused by kernel: " +
                "; ".join(f"{k} {v[0]:.4f} ({v[1]:g}x)" for k, v in
                          list(pr["unfused_breakdown"].items())[:10]))
        if "stages" in res:
            log(f"[kernel] {name} {dt}: {res['tail_launches']:g} launches per "
                "tail; per stage the launch plans (CTAs, shared memory "
                "bytes, N tile, rows per CTA) and one k=11 conv (d=1):")
            for st in res["stages"]:
                convt = (f" ConvT {st['convt_plan']};" if "convt_plan" in st
                         else "")
                pairs = (f" pairs {st['pair_plans']};" if "pair_plans" in st
                         else "")
                log(f"[kernel]   stage {st['stage']} C={st['channels']} "
                    f"T={st['rows']}:{convt} convs {st['conv_plans']};{pairs}"
                    " k=11 "
                    f"kernel {st['k11_ms']:.4f} ms, F.conv1d true f32 "
                    f"(library) {st['k11_library_ms']:.4f} ms, bound "
                    f"{st['k11_bound_ms']:.4f} ms, rel_l2 "
                    f"{st['k11_rel_l2']:.2e}")
        if name == "plms_ladder":
            log(f"[kernel] {name} {dt}: final x rel_l2="
                f"{res['final_x_rel_l2']:.3e}, eps part of x "
                f"{res['eps_share']:.3e}")
        if "per_output" in res:
            log(f"[kernel] {name} {dt} B={res['batch']} fwd+bwd: " + " ".join(
                f"{k}={v['rel_l2']:.2e}" for k, v in res["per_output"].items()))
        if name == "residual_stack_train":
            log(f"[kernel] {name} {dt}: route {res['route']}; batch of "
                f"{res['batch']} equals the in-order sum of its B=1 runs bit "
                f"for bit: {res['batch_is_sum_of_b1']}; against K4 at the f32 "
                "stream: " + " ".join(f"{k}={v:.2e}" for k, v in
                                      res["vs_k4_f32"].items()))
            if not res["batch_is_sum_of_b1"]:
                raise SmokeError("K5's batch differs from the in-order sum of "
                                 "its B=1 runs")
        if not res["rel_l2"] <= tol:
            raise SmokeError(f"{name} {dt} disagrees with its plain version: "
                             f"rel_l2 {res['rel_l2']:.3e} > {tol:g}")
        for k, v in res["fault_rel_l2"].items():
            if not v > tol:
                raise SmokeError(f"{name} {dt}: the planted fault '{k}' reads "
                                 f"{v:.3e}, within the tolerance {tol:g}")
        out.setdefault(name, {})[dt] = res
    return out


# ---------------------------------------------------------------------------
# Phase 4: the slice through Svc + run_clip
# ---------------------------------------------------------------------------

def phase_slice(device, workdir):
    """Convert the clips through Svc + run_clip in bf16 and f32."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch import infer_cli
    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.models.hubert import HubertConfig
    from diffsvc_tpu_torch.ops.hopper import (diffnet_stack, plms_ladder,
                                              vocoder_tail)
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import load_wav, save_wav

    counters = {"residual_stack": diffnet_stack, "plms_ladder": plms_ladder,
                "vocoder_tail": vocoder_tail}
    t0 = time.time()
    cfg_fn, ckpt = synth.write_project(
        os.path.join(workdir, "proj"),
        {"base_config": [os.path.join(ROOT, "configs", "config_44k.yaml")]},
        VOC_H, hubert_cfg=HubertConfig())
    log(f"[slice] wrote checkpoints in {time.time() - t0:.2f}s")
    sr = 44100
    wavs = []
    for i, (secs, f0, gaps) in enumerate(CLIPS):
        fn = os.path.join(workdir, f"clip{i}.wav")
        save_wav(synth.voiced_wav(secs, sr, f0, gaps, seed=i), fn, sr)
        wavs.append(fn)

    results = {"clips": []}
    svcs = {}
    for dt in ("bfloat16", ""):
        t0 = time.time()
        svcs[dt] = Svc("proj", cfg_fn, True, ckpt, device=device)
        svcs[dt].hp["diff_compute_dtype"] = dt
        log(f"[slice] Svc({dt or 'float32'}) loaded in {time.time() - t0:.2f}s")
    # warm up each Svc once on a short clip (cuDNN/cuFFT plans, allocator)
    for svc in svcs.values():
        svc.infer(wavs[0], key=0, acc=ACC, use_pe=False, use_crepe=False)
    torch.cuda.synchronize()

    for mod in counters.values():
        mod.launches = 0
    results["launches_tc"] = {}
    tc_counters = ("launches_tc", "launches_tf32x3")
    results["launches_k3"] = {}
    for dt, svc in svcs.items():
        for mod in (diffnet_stack, plms_ladder):
            for k in tc_counters:
                setattr(mod, k, 0)
        k3_before = vocoder_tail.launches
        for fn, (secs, _, _) in zip(wavs, CLIPS):
            out_fn = fn[:-4] + f"_{dt or 'f32'}_out.wav"
            t0 = time.time()
            with phase_sums(svc) as phases:
                _, f0_pred, audio = infer_cli.run_clip(
                    svc, key=0, acc=ACC, use_pe=False, use_crepe=False,
                    thre=0.05, use_gt_mel=False, add_noise_step=500,
                    file_path=fn, out_path=out_fn)
                torch.cuda.synchronize()
            wall = time.time() - t0
            src, _ = load_wav(fn)
            got, got_sr = load_wav(out_fn)
            audio = np.asarray(audio, np.float32)
            rec = {"dtype": dt or "float32", "secs": secs, "wall_s": wall,
                   "rtf": wall / secs, "out_len": len(got),
                   "in_len": len(src), "peak": float(np.abs(audio).max()),
                   "phases_s": phases,
                   "outside_phases_s": wall - sum(phases.values())}
            log(f"[slice] {rec['dtype']} clip {secs:.1f}s: wall={wall:.3f}s "
                f"rtf={rec['rtf']:.4f} peak={rec['peak']:.3f} host phases "
                f"summed over its chunks "
                f"{ {k: round(v, 4) for k, v in phases.items()} }, outside "
                f"them {rec['outside_phases_s']:.4f}s")
            if got_sr != sr or len(got) != len(src) or len(audio) != len(src):
                raise SmokeError(f"output length {len(got)} != input {len(src)}")
            if not np.isfinite(audio).all():
                raise SmokeError("non-finite output audio")
            if rec["peak"] < 1e-3:
                raise SmokeError("silent output audio")
            results["clips"].append(rec)
        # bf16 conversions move launches_tc and not launches_tf32x3, f32
        # ones the reverse
        tc = {k: {"residual_stack": getattr(diffnet_stack, k),
                  "plms_ladder": getattr(plms_ladder, k)}
              for k in tc_counters}
        results["launches_tc"][dt or "float32"] = tc
        k3 = vocoder_tail.launches - k3_before
        results["launches_k3"][dt or "float32"] = k3
        log(f"[slice] {dt or 'float32'} conversions: tensor-core launches {tc}"
            f"; K3 tails {k3}")
        if k3 <= 0:
            raise SmokeError(f"{dt or 'float32'} conversions did not run K3")
        want = "launches_tc" if dt == "bfloat16" else "launches_tf32x3"
        if any((n > 0) != (k == want) for k in tc_counters
               for n in tc[k].values()):
            raise SmokeError(f"{dt or 'float32'} conversions: tensor-core "
                             f"launches {tc} (must move {want} alone)")
    launches = {name: mod.launches for name, mod in counters.items()}
    results["launches"] = launches
    log(f"[slice] kernel launches on the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise SmokeError(f"kernel {name} was not launched on the main path")
    results["cpu_agreement"] = {
        dt or "float32": cpu_agreement(svc, cfg_fn, ckpt, wavs[0])
        for dt, svc in svcs.items()}
    results["profile"] = {
        dt or "float32": profile_clip(svc, wavs[-1], wavs[-1][:-4] + "_prof.wav")
        for dt, svc in svcs.items()}
    names = {dt: prof.pop("names")
             for dt, prof in results["profile"].items()}
    simt_bf16 = [n for n in names["bfloat16"] if re.search(
        r"\b(gate|out)_kernel<[^>]*bfloat16", n)]
    if simt_bf16 or not any("gate_tc_kernel" in n for n in names["bfloat16"]):
        raise SmokeError("the bf16 conversion's profile lacks K1's tensor-core "
                         f"kernels or runs SIMT layer kernels: {simt_bf16}")
    simt = [n for n in names["float32"]
            if re.search(r"\b(gate|out)_kernel<", n)]
    if simt or not any("tf32x3::gate_kernel" in n for n in names["float32"]):
        raise SmokeError("the f32 conversion's profile lacks K1's 3xTF32 "
                         f"kernels or runs SIMT layer kernels: {simt}")
    # the vocoder is f32 in both: K3's tensor-core kernels, no SIMT conv
    for dt, ns in names.items():
        simt = [n for n in ns if re.search(r"(^|::)conv1d_kernel\b", n)]
        if simt or not any("tail::conv_tc_kernel" in n for n in ns):
            raise SmokeError(f"the {dt} conversion's profile lacks K3's "
                             f"tensor-core kernels or runs SIMT ones: {simt}")
    project = {"cfg_fn": cfg_fn, "ckpt": ckpt, "wavs": wavs, "svcs": svcs}
    return results, project


@contextlib.contextmanager
def phase_sums(svc):
    """``Svc.timings`` (seconds per phase of one ``infer``) summed over every
    ``infer`` inside the block, into the dict it yields."""
    sums, real = {}, svc.infer

    def summed(*args, **kwargs):
        out = real(*args, **kwargs)
        for k, v in svc.timings.items():
            sums[k] = sums.get(k, 0.0) + v
        return out

    svc.infer = summed
    try:
        yield sums
    finally:
        del svc.infer


def profile_clip(svc, wav_fn, out_fn):
    """Where the time goes: torch.profiler over one run_clip."""
    from diffsvc_tpu_torch import infer_cli

    return profile_run(
        f"{svc.hp['diff_compute_dtype'] or 'float32'} run_clip",
        lambda: infer_cli.run_clip(svc, key=0, acc=ACC, use_pe=False,
                                   use_crepe=False, thre=0.05,
                                   use_gt_mel=False, add_noise_step=500,
                                   file_path=wav_fn, out_path=out_fn))


def profile_run(label, fn):
    """torch.profiler over one call of ``fn``.  Device busy time is the
    union of the card's kernel and copy intervals; the busy share is that
    over the profiled wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        tot = by_name.setdefault(e.name, [0.0, 0])
        tot[0] += (e.time_range.end - e.time_range.start) / 1e3
        tot[1] += 1
    busy_us, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy_us += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    res = {"wall_s": wall, "device_busy_ms": busy_us / 1e3,
           "busy_share": busy_us / 1e6 / wall, "device_events": len(spans),
           "top": sorted(([k, v[0], v[1]] for k, v in by_name.items()),
                         key=lambda r: -r[1])[:8], "names": sorted(by_name)}
    log(f"[profile] {label}: wall={wall:.3f}s "
        f"device_busy={res['device_busy_ms']:.1f}ms "
        f"busy_share={res['busy_share']:.3f} ({len(spans)} device events)")
    for name, ms, n in res["top"]:
        log(f"[profile]   {ms:9.2f} ms {n:6d}x {name[:110]}")
    return res


@contextlib.contextmanager
def zeroed(*params):
    """Parameters set to zero for the duration of the block."""
    import torch

    saved = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p in params:
            p.zero_()
    try:
        yield
    finally:
        with torch.no_grad():
            for p, v in zip(params, saved):
                p.copy_(v)


def cpu_agreement(svc_dev, cfg_fn, ckpt, wav_fn, acc=ACC, tag="slice",
                  same_f0=False, **infer_kw):
    """The same short conversion on the card and on the CPU (plain
    versions), at ``svc_dev``'s diff_compute_dtype and ``acc`` (at acc=1
    DDPM, its per-step noise shared too; ``infer_kw``: e.g. use_gt_mel),
    with the sampler noise and the NSF source draws shared.  ``same_f0``:
    the card's conversions take the CPU's f0 track, and the one with the
    card's own track is the diagnostic (for a check of the sampler whose
    denoiser part is too small a share of the waveform to see past the
    tracker's device difference).  As for the ladder, the waveforms are
    compared on what the denoiser put in them: each minus the CPU's
    conversion with eps = 0 (output projection zeroed).  They must agree to
    SLICE_TOL in f32 (f32 sums in other orders through ~1000 denoiser layers
    and the vocoder) or SLICE_TOL_BF16 in bf16, and the card's conversion
    with the denoiser's skip-projection bias dropped must not."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.utils.audio_io import load_wav, save_wav
    from diffsvc_tpu_torch.vocoders.generator import draw_randoms

    secs = 0.5
    wav, sr = load_wav(wav_fn)
    short = wav_fn[:-4] + "_short.wav"
    save_wav(wav[: int(secs * sr)], short, sr)
    dt = svc_dev.hp["diff_compute_dtype"] or "float32"
    tol = SLICE_TOL_BF16 if dt == "bfloat16" else SLICE_TOL
    svc_cpu = Svc("proj", cfg_fn, False, ckpt, device="cpu")
    svc_cpu.hp["diff_compute_dtype"] = svc_dev.hp["diff_compute_dtype"]
    batch = svc_cpu.pre(short, acc, use_crepe=False)
    t_mel = batch["mels"].shape[1]
    g = torch.Generator().manual_seed(3)
    noise = torch.randn(1, t_mel, svc_cpu.mel_bins, generator=g)
    if acc <= 1:
        n_steps = int(infer_kw["add_noise_step"]) if infer_kw.get(
            "use_gt_mel") else svc_cpu.model.K_step
        infer_kw = dict(infer_kw, step_noise=torch.randn(
            n_steps, 1, t_mel, svc_cpu.mel_bins, generator=g))
    n_real = int((np.abs(batch["mels"][0]).sum(-1) > 0).sum())
    hop = int(svc_cpu.hp["hop_size"])
    randoms = draw_randoms(1, n_real * hop, svc_cpu.vocoder.cfg.harmonic_num, g)

    def convert(svc):
        dev_randoms = tuple(r.to(svc.device) for r in randoms)
        _, _, out = svc.infer(short, key=0, acc=acc, use_pe=False,
                              use_crepe=False, init_noise=noise,
                              voc_randoms=dev_randoms, **infer_kw)
        return torch.from_numpy(np.asarray(out, np.float32))

    ref = convert(svc_cpu)
    out_proj = svc_cpu.model.denoise_fn.output_projection
    with zeroed(out_proj.weight, out_proj.bias):
        base = convert(svc_cpu)
    from diffsvc_tpu_torch.data import features

    @contextlib.contextmanager
    def cpu_track(on=True):
        """The card's conversions with the CPU's f0 track (the AC tracker
        runs on each side's device; cuFFT's ACF moves the track by ~1e-6
        relative), so that what remains is the kernels' difference."""
        if on:
            svc_dev._cached_pitch = lambda wav, mel, use_crepe, thre: \
                features.get_pitch(wav, mel, svc_dev.hp, use_crepe, thre,
                                   device="cpu")
        try:
            yield
        finally:
            if on:
                del svc_dev._cached_pitch

    with cpu_track(same_f0):
        got = convert(svc_dev)
        with zeroed(svc_dev.model.denoise_fn.skip_projection.bias):
            fault = convert(svc_dev)
    # the diagnostic: the other track on the card
    with cpu_track(not same_f0):
        other_f0 = convert(svc_dev)
    res = {"rel_l2": rel_l2(got - base, ref - base),
           "f0_track_of_card": "cpu" if same_f0 else "card",
           "rel_l2_other_f0": rel_l2(other_f0 - base, ref - base),
           "wav_rel_l2": rel_l2(got, ref), "eps_share": rel_l2(ref, base),
           "max_abs_err": float((got - ref).abs().max()),
           "fault_rel_l2": rel_l2(fault - base, ref - base),
           "tol_rel_l2": tol, "secs": secs}
    res["mode"] = f"acc={acc}" + (
        f", use_gt_mel at {infer_kw['add_noise_step']} steps"
        if infer_kw.get("use_gt_mel") else "")
    log(f"[{tag}] {dt} card vs CPU on {secs}s ({res['mode']}): "
        f"rel_l2={res['rel_l2']:.3e} "
        f"(tol {tol:g}; waveform itself {res['wav_rel_l2']:.3e}, eps "
        f"part of it {res['eps_share']:.3e}) max_abs={res['max_abs_err']:.3e}"
        f"; planted fault [bskip dropped: {res['fault_rel_l2']:.3e}]; the "
        f"card's conversions on the {res['f0_track_of_card']}'s f0 track; "
        f"on the other one: {res['rel_l2_other_f0']:.3e}")
    if not res["rel_l2"] <= tol:
        raise SmokeError(f"card and CPU conversions disagree: {res}")
    if not res["fault_rel_l2"] > tol:
        raise SmokeError(f"the planted fault passes the card-vs-CPU check: {res}")
    return res


# ---------------------------------------------------------------------------
# Phase 7: serving (the fused program, batched chunks, the HTTP server)
# ---------------------------------------------------------------------------

# Batched fused conversion against each chunk's own B=1 fused call on the
# same padding and noise, at f32: relative L2 of the waveform.  The rows of
# a batch meet only in the kernels' tiling, so they agree to the f32 sums'
# order.
BATCHED_TOL = 1e-4
SERVE_CLIP = -1          # the 14 s clip of phase 4
# (seconds, f0 Hz, silent spans): three voiced chunks of 5.2-5.6 s, which
# the collate pads to one length (512 frames): one group, B = 3
BATCH_CLIP = (17.0, 262.0, [(5.6, 6.4), (11.4, 12.2)])
SERVER_SECS = 2.0        # the fused requests' buffer
STREAM_SECS = 0.5        # the streamed requests' buffer


def kernel_counts() -> dict:
    """K1-K5's counters (K6's is read as a difference by :func:`counted`:
    its count over phases 4-9 must stay whole)."""
    from diffsvc_tpu_torch.ops.hopper import (diffnet_stack,
                                              diffnet_stack_per_sample,
                                              diffnet_stack_train,
                                              plms_ladder, vocoder_tail)

    return {"residual_stack": diffnet_stack.launches,
            "plms_ladder": plms_ladder.launches,
            "vocoder_tail": vocoder_tail.launches,
            "residual_stack_train_batched": diffnet_stack_train.launches,
            "residual_stack_train": diffnet_stack_per_sample.launches}


ALL_KERNELS = ("residual_stack", "plms_ladder", "vocoder_tail",
               "residual_stack_train_batched", "residual_stack_train",
               "fused_residual_block")


@contextlib.contextmanager
def counted(label: str, into: dict, moved=("plms_ladder", "vocoder_tail"),
            still=(), tag="serve"):
    """K1-K5's counters set to 0 before the block and read after it, and
    K6's launches in the block (its counter's rise): every kernel's count
    for the block.  The kernels in ``moved`` must have moved and those in
    ``still`` must not."""
    from diffsvc_tpu_torch.ops.hopper import (diffnet_block, diffnet_stack,
                                              diffnet_stack_per_sample,
                                              diffnet_stack_train,
                                              plms_ladder, vocoder_tail)

    for mod in (diffnet_stack, plms_ladder, vocoder_tail,
                diffnet_stack_train, diffnet_stack_per_sample):
        mod.launches = 0
    k6_before = diffnet_block.launches
    yield
    import torch

    torch.cuda.synchronize()
    into[label] = dict(kernel_counts(), fused_residual_block=(
        diffnet_block.launches - k6_before))
    log(f"[{tag}] {label}: kernel launches {into[label]}")
    for name in moved:
        if into[label][name] <= 0:
            raise SmokeError(f"{label} did not launch {name}")
    for name in still:
        if into[label][name] != 0:
            raise SmokeError(f"{label} launched {name} "
                             f"{into[label][name]} times")


def voiced_chunks(wav_fn):
    """The slicer's voiced chunks of a clip (float32 at its rate)."""
    from diffsvc_tpu_torch.infer import slicer

    chunks = slicer.cut(wav_fn, db_thresh=-40)
    data, _ = slicer.chunks2audio(wav_fn, chunks)
    return [d.astype("float32") for tag, d in data if not tag]


def fused_trace(label, fn):
    """torch.profiler over one fused chunk: the device busy share, and no
    device-to-host copy may start before the chunk's last kernel ends (the
    program keeps everything on the card until its outputs)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels, d2h, spans = [], [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        spans.append(span)
        if "DtoH" in e.name or "Device -> Pageable" in e.name \
                or "Device -> Pinned" in e.name:
            d2h.append((span, e.name))
        elif "Memcpy" not in e.name and "Memset" not in e.name:
            kernels.append((span, e.name))
    busy_us, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy_us += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    last_kernel = max(b for (_, b), _ in kernels)
    early = [n for (a, _), n in d2h if a < last_kernel]
    res = {"wall_s": wall, "device_busy_ms": busy_us / 1e3,
           "busy_share": busy_us / 1e6 / wall, "kernels": len(kernels),
           "d2h": len(d2h), "d2h_before_last_kernel": early,
           "k3_traced": any("tail::" in n for _, n in kernels),
           "k1_traced": any("gate" in n for _, n in kernels)}
    log(f"[serve] profile of {label}: wall={wall:.4f}s device_busy="
        f"{res['device_busy_ms']:.2f}ms busy_share={res['busy_share']:.3f} "
        f"kernels={len(kernels)} (K1 traced {res['k1_traced']}, K3 traced "
        f"{res['k3_traced']}); device-to-host copies {len(d2h)}, before the "
        f"last kernel {len(early)}")
    if early:
        raise SmokeError(f"{label}: device-to-host copies before the last "
                         f"kernel: {early}")
    if not (res["k1_traced"] and res["k3_traced"]):
        raise SmokeError(f"{label}: the trace lacks the program's kernels")
    return res


def route_run(label, secs, n_chunks, fn, pools=0):
    """A route's wall over one conversion (host clock, ending in a sync),
    then a profiled one for the device busy share."""
    import torch

    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    prof = profile_run(f"{label} (serve)", fn)
    prof.pop("names")
    rec = {"wall_s": wall, "rtf": wall / secs, "chunks": n_chunks,
           "wall_per_chunk_s": wall / n_chunks,
           "busy_share": prof["busy_share"],
           "device_busy_ms": prof["device_busy_ms"],
           "graph_pool_mib": pools / 2 ** 20}
    log(f"[serve] route {label}: wall={wall:.4f}s rtf={rec['rtf']:.4f} "
        f"per chunk {rec['wall_per_chunk_s']:.4f}s busy_share="
        f"{rec['busy_share']:.3f} device_busy={rec['device_busy_ms']:.1f}ms "
        f"graph pools {rec['graph_pool_mib']:.1f} MiB")
    return rec


def fused_cpu_agreement(svc_dev, project, chunk):
    """A 0.5 s fused conversion on the card against the same fused
    conversion on the CPU (plain versions), the same noise, compared on
    what the denoiser put in the waveform (each minus the CPU's conversion
    with eps = 0), at phase 4's limits; the card's program with the
    denoiser's skip-projection bias dropped must exceed them."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.infer.fused import FusedSvc
    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.vocoders.generator import draw_randoms

    dt = svc_dev.hp["diff_compute_dtype"] or "float32"
    tol = SLICE_TOL_BF16 if dt == "bfloat16" else SLICE_TOL
    svc_cpu = Svc("proj", project["cfg_fn"], True, project["ckpt"],
                  device="cpu")
    wav = chunk[: int(0.5 * 44100)]
    hp = dict(svc_dev.hp, fused_bucket_samples=0)

    def fused_of(svc, cuda_graphs=True):
        return FusedSvc(type(svc.hp)(hp), svc.model, svc.vocoder,
                        svc.hubert.model, speedup=ACC,
                        cuda_graphs=cuda_graphs)

    f_cpu = fused_of(svc_cpu)
    geo = f_cpu.geometry(len(wav))
    g = torch.Generator().manual_seed(3)
    noise = torch.randn(1, geo["pad_t"], svc_cpu.mel_bins, generator=g)
    randoms = draw_randoms(1, geo["n_voc"], svc_cpu.vocoder.cfg.harmonic_num,
                           g)

    def convert(f):
        return torch.from_numpy(np.asarray(f(wav, init_noise=noise,
                                             voc_randoms=randoms)[0]))

    ref = convert(f_cpu)
    out_proj = svc_cpu.model.denoise_fn.output_projection
    with zeroed(out_proj.weight, out_proj.bias):
        base = convert(fused_of(svc_cpu))
    f_dev = fused_of(svc_dev)
    got = convert(f_dev)
    with zeroed(svc_dev.model.denoise_fn.skip_projection.bias):
        fault = convert(fused_of(svc_dev, cuda_graphs=False))
    # diagnostic: the card's program (eager) with the tracker run on the CPU
    from diffsvc_tpu_torch.ops import f0_ac

    real_track = f0_ac.track
    f0_ac.track = lambda w, **kw: real_track(w.cpu(), **kw).to(w.device)
    try:
        cpu_f0 = convert(fused_of(svc_dev, cuda_graphs=False))
    finally:
        f0_ac.track = real_track
    res = {"rel_l2": rel_l2(got - base, ref - base),
           "rel_l2_cpu_f0": rel_l2(cpu_f0 - base, ref - base),
           "wav_rel_l2": rel_l2(got, ref), "eps_share": rel_l2(ref, base),
           "max_abs_err": float((got - ref).abs().max()),
           "fault_rel_l2": rel_l2(fault - base, ref - base),
           "tol_rel_l2": tol}
    log(f"[serve] {dt} fused card vs CPU on 0.5s: rel_l2={res['rel_l2']:.3e} "
        f"(tol {tol:g}; waveform itself {res['wav_rel_l2']:.3e}, eps part "
        f"{res['eps_share']:.3e}) max_abs={res['max_abs_err']:.3e}; planted "
        f"fault [bskip dropped: {res['fault_rel_l2']:.3e}]; with the tracker "
        f"on the CPU on both sides: {res['rel_l2_cpu_f0']:.3e}")
    if not res["rel_l2"] <= tol:
        raise SmokeError(f"fused card and CPU conversions disagree: {res}")
    if not res["fault_rel_l2"] > tol:
        raise SmokeError(f"the planted fault passes the fused check: {res}")
    return res


def replay_equals_eager(svc, chunk):
    """The same chunk, noise and padding through the captured program and
    through the same body run eagerly on the card: equal bit for bit."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.infer.fused import FusedSvc
    from diffsvc_tpu_torch.vocoders.generator import draw_randoms

    graphed = svc.fused_model(ACC)
    eager = FusedSvc(graphed.hp, svc.model, svc.vocoder, svc.hubert.model,
                     speedup=ACC, cuda_graphs=False)
    geo = graphed.geometry(graphed._padded_length(len(chunk)))
    g = torch.Generator(device=svc.device).manual_seed(11)
    noise = torch.randn(1, geo["pad_t"], svc.mel_bins, generator=g,
                        device=svc.device)
    randoms = draw_randoms(1, geo["n_voc"], svc.vocoder.cfg.harmonic_num, g,
                           svc.device)
    outs = [f(chunk, init_noise=noise, voc_randoms=randoms)
            for f in (graphed, eager, graphed)]
    same = all(np.array_equal(a, b) for o in outs[1:]
               for a, b in zip(outs[0], o))
    if not same:
        diffs = [float(np.abs(a.astype(np.float64) - b).max())
                 for a, b in zip(outs[0], outs[1])]
        raise SmokeError(f"graph replay differs from eager: max |diff| "
                         f"(wav, f0, mel) {diffs}")
    return same


def batched_vs_single(svc, chunks):
    """FusedSvc.batched at B = len(chunks) against each chunk's B=1 fused
    call on the same padding and noise."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.vocoders.generator import draw_randoms

    fused = svc.fused_model(ACC)
    n = len(chunks)
    n44 = fused._padded_length(max(len(c) for c in chunks))
    geo = fused.geometry(n44)
    g = torch.Generator(device=svc.device).manual_seed(5)
    noise = torch.randn(n, geo["pad_t"], svc.mel_bins, generator=g,
                        device=svc.device)
    randoms = draw_randoms(n, geo["n_voc"], svc.vocoder.cfg.harmonic_num, g,
                           svc.device)
    outs = fused.batched(chunks, init_noise=noise, voc_randoms=randoms)
    rels = []
    for i, c in enumerate(chunks):
        padded = np.zeros(n44, np.float32)
        padded[: len(c)] = c
        ref = fused(padded, init_noise=noise[i: i + 1],
                    voc_randoms=tuple(r[i: i + 1] for r in randoms))[0]
        got = fused.to_float(outs[i][0])
        rels.append(rel_l2(torch.from_numpy(np.asarray(got, np.float32)),
                           torch.from_numpy(np.asarray(fused.to_float(
                               ref[: len(c)]), np.float32))))
    log(f"[serve] fused batched B={n} vs B=1 calls (f32, same padding and "
        f"noise): rel_l2 per chunk {[f'{r:.2e}' for r in rels]} (tol "
        f"{BATCHED_TOL:g})")
    if not max(rels) <= BATCHED_TOL:
        raise SmokeError(f"batched chunks disagree with their B=1 calls: "
                         f"{rels}")
    return rels


def serve_http(svc):
    """The port's server in this process on 127.0.0.1: three fused
    requests, three streamed ones (each answered 200 with the posted
    duration) and a malformed one (400)."""
    import io
    import threading
    import urllib.error
    import urllib.request
    from http.server import HTTPServer

    import numpy as np
    from scipy.io import wavfile

    from diffsvc_tpu_torch import flask_api
    from diffsvc_tpu_torch.utils import synth

    sr = 44100
    flask_api.warmup_fused(svc, ACC, SERVER_SECS)
    boundary = "smokeboundary"

    def body(wav, pitch="0"):
        buf = io.BytesIO()
        wavfile.write(buf, sr, (wav * 32767).astype(np.int16))
        out = b""
        for k, v in {"fPitchChange": pitch, "sampleRate": str(sr)}.items():
            out += (f"--{boundary}\r\nContent-Disposition: form-data; "
                    f'name="{k}"\r\n\r\n{v}\r\n').encode()
        out += (f"--{boundary}\r\nContent-Disposition: form-data; "
                'name="sample"; filename="in.wav"\r\nContent-Type: '
                "audio/wav\r\n\r\n").encode()
        return out + buf.getvalue() + f"\r\n--{boundary}--\r\n".encode()

    def post(port, data):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/voiceChangeModel", data=data,
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"},
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                _, out = wavfile.read(io.BytesIO(resp.read()))
                return resp.status, len(out)
        except urllib.error.HTTPError as e:
            return e.code, 0

    wav = synth.voiced_wav(3 * SERVER_SECS, sr, 240.0, seed=7)
    answers = {}
    stream = flask_api.make_stream(svc, ACC, fused=True)
    for label, st in (("fused", None), ("stream", stream)):
        server = HTTPServer(("127.0.0.1", 0),
                            flask_api.make_handler(svc, ACC, fused=True,
                                                   stream=st))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            n = int((SERVER_SECS if st is None else STREAM_SECS) * sr)
            got = []
            for k in range(3):
                t0 = time.time()
                status, length = post(server.server_address[1],
                                      body(wav[k * n: (k + 1) * n], "2"))
                got.append({"status": status, "samples": length,
                            "want": n, "wall_s": time.time() - t0})
            if st is None:
                got.append({"malformed": post(server.server_address[1],
                                              body(wav[:n])[:200])[0]})
            answers[label] = got
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    log(f"[serve] HTTP answers: {answers}")
    for label, got in answers.items():
        for r in got[:3]:
            if r["status"] != 200 or r["samples"] != r["want"]:
                raise SmokeError(f"server {label} answered {r}")
    if answers["fused"][3]["malformed"] != 400:
        raise SmokeError(f"a malformed request was answered "
                         f"{answers['fused'][3]}")
    return answers


def phase_serve(device, project):
    """Phase 7 on phase 4's project: the fused routes (bf16 and f32), the
    batched routes, and the server."""
    import torch

    from diffsvc_tpu_torch import infer_cli
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import save_wav

    wav_fn = project["wavs"][SERVE_CLIP]
    secs = CLIPS[SERVE_CLIP][0]
    chunks = voiced_chunks(wav_fn)
    res = {"launches": {}, "routes": {}, "captures": {}}

    def clip(svc, file_path=wav_fn, **route):
        return infer_cli.run_clip(
            svc, key=0, acc=ACC, use_pe=False, use_crepe=False, thre=0.05,
            use_gt_mel=False, add_noise_step=500, file_path=file_path,
            out_path=file_path[:-4] + "_serve.wav", **route)

    batch_fn = os.path.join(os.path.dirname(wav_fn), "batch_clip.wav")
    secs_b, f0_b, gaps_b = BATCH_CLIP
    save_wav(synth.voiced_wav(secs_b, 44100, f0_b, gaps_b, seed=5), batch_fn,
             44100)
    batch_chunks = voiced_chunks(batch_fn)
    for dt, svc in project["svcs"].items():
        name = dt or "float32"
        # (a) fused: every bucket captured once on the first conversion
        with counted(f"fused {name}", res["launches"]):
            clip(svc, fused=True)
        fused = svc.fused_model(ACC)
        res["captures"][name] = {str(k[:2]): v
                                 for k, v in fused.captures.items()}
        routes = res["routes"].setdefault(name, {})
        routes["modular"] = route_run(f"modular {name}", secs, len(chunks),
                                      lambda: clip(svc))
        routes["fused graph"] = route_run(
            f"fused graph {name}", secs, len(chunks),
            lambda: clip(svc, fused=True),
            sum(fused.pool_bytes().values()))
        saved = fused.cuda_graphs, fused._fns
        fused.cuda_graphs, fused._fns = False, {}
        try:
            routes["fused eager"] = route_run(
                f"fused eager {name}", secs, len(chunks),
                lambda: clip(svc, fused=True))
        finally:
            fused.cuda_graphs, fused._fns = saved
        routes["batched"] = route_run(f"batched {name}", secs, len(chunks),
                                      lambda: clip(svc, batch_chunks=True))
        # (b) the batched route where the chunks form one group: K2 and K3
        # once per conversion, at B = the voiced chunks
        groups = res.setdefault("batch_clip", {}).setdefault(name, {})
        for route, kw in (("modular", {}), ("fused graph", {"fused": True}),
                          ("batched", {"batch_chunks": True})):
            with counted(f"{route} {name}, batch clip", res["launches"]):
                groups[route] = route_run(
                    f"{route} {name}, {len(batch_chunks)}-chunk clip",
                    BATCH_CLIP[0], len(batch_chunks),
                    lambda kw=kw: clip(svc, file_path=batch_fn, **kw))
        got = res["launches"][f"batched {name}, batch clip"]
        if (got["plms_ladder"], got["vocoder_tail"]) != (2, 2):
            raise SmokeError(f"the {len(batch_chunks)}-chunk clip's batched "
                             f"conversions did not run K2 and K3 once each "
                             f"at B = {len(batch_chunks)}: {got}")
        if any(v != 1 for v in fused.captures.values()):
            raise SmokeError(f"a bucket was captured more than once: "
                             f"{fused.captures}")
        res.setdefault("replay_equals_eager", {})[name] = \
            replay_equals_eager(svc, chunks[0])
        log(f"[serve] {name}: graph replay equals eager bit for bit; "
            f"captures per bucket {res['captures'][name]}; graph pools "
            f"{ {str(k[:2]): round(v / 2 ** 20, 1) for k, v in fused.pool_bytes().items()} } MiB")
        res.setdefault("trace", {})[name] = fused_trace(
            f"one fused chunk ({name}, {len(chunks[0]) / 44100:.2f}s)",
            lambda: svc.infer_fused(chunks[0], key=0, acc=ACC))
        res.setdefault("cpu_agreement", {})[name] = fused_cpu_agreement(
            svc, project, chunks[0])
    # (b) batched fused at B = the voiced chunks, against B=1 calls (f32)
    svc32 = project["svcs"][""]
    with counted("fused batched float32", res["launches"]):
        res["batched_rel_l2"] = batched_vs_single(svc32, batch_chunks)
    # (c) the server (bf16, the production serving mode)
    with counted("server bfloat16", res["launches"]):
        res["server"] = serve_http(project["svcs"]["bfloat16"])
    torch.cuda.synchronize()
    return res


# ---------------------------------------------------------------------------
# Phase 5: the training path (binarize -> run.py -> checkpoints -> Svc)
# ---------------------------------------------------------------------------

TRAIN_CLIPS, TRAIN_SR = 32, 44100   # synthetic voiced clips of 4-12 s
TRAIN_STEPS, VAL_EVERY = 6, 3
# One step on the card, kernels vs the plain versions on the card (same
# state, batch, t and noise; bf16 streams; the output head drawn at random
# so the loss depends on the denoiser): the largest of the relative
# differences of the loss and of grad_norm and the rel-L2 of the residual
# layers' grads.  The planted fault drops the last sample's cotangent in
# K4's backward.  Sound 7.8e-4, fault 3.8e-2 on the H100.
TRAIN_STEP_TOL = 5e-3


def train_config(workdir: str) -> dict:
    """config_44k at full width with max_sentences 24; 6 steps, validation
    and a checkpoint every 3; every step logged; no validation plots; the
    AC f0 tracker (``use_crepe: false``; phase 8 binarizes with CREPE)."""
    return {"base_config": [os.path.join(ROOT, "configs", "config_44k.yaml")],
            "raw_data_dir": os.path.join(workdir, "raw"),
            "binary_data_dir": os.path.join(workdir, "bin"),
            "work_dir": os.path.join(workdir, "work"),
            "hubert_path": os.path.join(workdir, "hubert", "hubert_soft.pt"),
            "vocoder_ckpt": os.path.join(workdir, "nsf_hifigan", "model"),
            "max_sentences": TRAIN_B, "max_updates": TRAIN_STEPS,
            "val_check_interval": VAL_EVERY, "log_interval": 1,
            "num_valid_plots": 0, "use_crepe": False}


@contextlib.contextmanager
def swapped(mod, **attrs):
    """Module attributes replaced for the duration of the block (the
    autograd Functions look their wrappers up at call time)."""
    saved = {k: getattr(mod, k) for k in attrs}
    for k, v in attrs.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)


def step_grads(task, batch, t, noise):
    """(loss, grad_norm, residual layers' grads) of one step, no update."""
    import torch

    from diffsvc_tpu_torch.training.task import global_norm

    loss, _ = task.model.training_loss(task.prepare_batch(batch), t=t,
                                       noise=noise)
    grads = torch.autograd.grad(loss, task.params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(task.params, grads)]
    inner = torch.cat([g.flatten() for n, g in zip(task.names, grads)
                       if ".residual_layers." in n])
    return float(loss.detach()), float(global_norm(grads)), inner


def card_vs_plain_step(task, batch, t, noise, mod, plain, bwd_name, tol,
                       tag="train"):
    """One step through the kernels and through the plain versions, both on
    the card (``plain``: (module, attributes) pairs, the wrappers that the
    route's autograd Function calls replaced by their plain versions); and
    through the kernels with a planted fault, the last sample's cotangent
    dropped in ``mod.<bwd_name>``."""
    import torch

    head = task.model.denoise_fn.output_projection
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        head.weight.copy_(torch.randn(head.weight.shape, generator=g) * 0.05)

    kernel_bwd = getattr(mod, bwd_name)

    def drop_last(xsave, sb, cp, wd, bd, wo, dout, *, cycle):
        dout = dout.clone()
        dout[-1] = 0
        return kernel_bwd(xsave, sb, cp, wd, bd, wo, dout, cycle=cycle)

    kern = step_grads(task, batch, t, noise)
    with contextlib.ExitStack() as stack:
        for m, attrs in plain:
            stack.enter_context(swapped(m, **attrs))
        plain = step_grads(task, batch, t, noise)
    with swapped(mod, **{bwd_name: drop_last}):
        fault = step_grads(task, batch, t, noise)

    def diff(a, b):
        return max(abs(a[0] - b[0]) / abs(b[0]), abs(a[1] - b[1]) / abs(b[1]),
                   rel_l2(a[2], b[2]))

    res = {"loss": kern[0], "plain_loss": plain[0], "grad_norm": kern[1],
           "plain_grad_norm": plain[1], "rel": diff(kern, plain),
           "fault_rel": diff(fault, plain), "tol": tol}
    log(f"[{tag}] one step, card kernels vs plain on the card: loss "
        f"{kern[0]:.6f}/{plain[0]:.6f} grad_norm {kern[1]:.6f}/{plain[1]:.6f}"
        f" -> {res['rel']:.3e} (tol {tol:g}); planted fault "
        f"[last sample's cotangent dropped: {res['fault_rel']:.3e}]")
    if not res["rel"] <= tol:
        raise SmokeError(f"the card's step disagrees with the plain one: {res}")
    if not res["fault_rel"] > tol:
        raise SmokeError(f"the planted fault passes the step check: {res}")
    return res


# The SIMT training kernels K4 and K5 ran before they moved to the tensor
# cores: no train-step profile may show one.
SIMT_TRAIN = re.compile(r"\b(gate_kernel<float|out_kernel<float|dh_kernel|"
                        r"dy_kernel|wgrad_out_kernel|wgrad_dil_kernel)\b")
TC_TRAIN = ("regate_tc_kernel", "dh_tc_kernel", "dy_tc_kernel",
            "wgrad_tc_kernel")


def check_train_profile(label: str, names, mode: str, forward: str) -> None:
    """A train step's profile runs the training stack on the tensor cores:
    the forward's layer kernel ``forward`` and each backward product's
    kernel in operand mode ``mode`` (``Bf16`` or ``Tf32x3``), and no SIMT
    training kernel."""
    simt = [n for n in names if SIMT_TRAIN.search(n)]
    missing = [k for k in TC_TRAIN
               if not any(k in n and f"::{mode}" in n for n in names)]
    if not any(forward in n for n in names):
        missing.append(forward)
    log(f"[profile] {label}: tensor-core training kernels "
        f"{'all present' if not missing else f'missing {missing}'}; SIMT "
        f"training kernels {simt or 'none'}")
    if simt or missing:
        raise SmokeError(f"{label} does not run the training stack on the "
                         f"tensor cores: missing {missing}, SIMT {simt}")


def time_steps(task, batch, reps: int) -> dict:
    """ms per train step (host clock ending in a sync, after one warm-up
    step), samples/s, mel frames/s and the peak of allocated memory."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    task.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(reps):
        task.train_step(batch)
    torch.cuda.synchronize()
    step_s = (time.time() - t0) / reps
    return {"ms_per_step": step_s * 1e3,
            "samples_per_s": batch["nsamples"] / step_s,
            "mel_frames_per_s": int(batch["mel_lengths"].sum()) / step_s,
            "padded_frames_per_s": batch["mels"].shape[0]
            * batch["mels"].shape[1] / step_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def log_steps(tag: str, label: str, batch, r: dict) -> None:
    log(f"[{tag}] {label}, B={batch['nsamples']} T={batch['mels'].shape[1]}"
        f": {r['ms_per_step']:.1f} ms/step, {r['samples_per_s']:.1f} "
        f"samples/s, {r['mel_frames_per_s']:.0f} mel frames/s "
        f"({int(batch['mel_lengths'].sum())} real frames), peak memory "
        f"{r['peak_mem_gb']:.2f} GB")


def batch_route(hp, b: int, t: int) -> str:
    """The training route ``diffnet.apply`` takes for a [B, T] batch."""
    from diffsvc_tpu_torch.models.diffnet import train_route

    return train_route(int(hp["residual_layers"]),
                       int(hp["dilation_cycle_length"]), t,
                       int(hp["residual_channels"]), b,
                       str(hp["diffnet_train_stream_dtype"]))


def time_train_steps(hp, device, batch, reps: int = 3):
    """ms per train step, samples/s and mel frames/s, per stream dtype, with
    the route each takes (at B=24, T=1024 the f32 stream exceeds K4's
    carry, so JAX and the port take the per-sample route, K5)."""
    import torch

    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.training.task import SVCTask

    out = {}
    for sd in ("bf16", "f32"):
        hp_sd = HParams(dict(hp, diffnet_train_stream_dtype=sd))
        task = SVCTask(hp_sd, device=device)
        out[sd] = dict(time_steps(task, batch, reps),
                       route=batch_route(hp_sd, *batch["mels"].shape[:2]))
        log_steps("train", f"{sd} streams ({out[sd]['route']} route)", batch,
                  out[sd])
        del task
        torch.cuda.empty_cache()
    return out


def phase_train(device, workdir):
    """Binarize synthetic clips with the port's binarizer (HuBERT-soft
    768 x 12 with random weights, on the card), train through the run.py
    entry, resume from the step-3 checkpoint, check determinism and the
    card against the plain versions, time both stream dtypes, profile one
    step, and convert a clip through Svc with the trained checkpoint."""
    import copy
    import glob
    import shutil

    import numpy as np
    import torch
    import yaml

    from diffsvc_tpu_torch import infer_cli
    from diffsvc_tpu_torch.config import HParams, set_hparams
    from diffsvc_tpu_torch.data.binarizer import binarize
    from diffsvc_tpu_torch.data.dataset import (BatchIterator,
                                                FastSpeechDataset,
                                                build_batches)
    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.models.hubert import HubertConfig
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4
    from diffsvc_tpu_torch.run import run_task
    from diffsvc_tpu_torch.training.trainer import Trainer
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import load_wav, save_wav
    from diffsvc_tpu_torch.utils.convert import strip_prefix, torch_load

    res = {}
    cfg = train_config(workdir)
    cfg_fn = os.path.join(workdir, "train.yaml")
    with open(cfg_fn, "w") as f:
        yaml.safe_dump(cfg, f)
    synth.write_hubert(cfg["hubert_path"], HubertConfig(), seed=2)
    synth.write_nsf_generator(os.path.dirname(cfg["vocoder_ckpt"]), VOC_H, 1)
    sr = TRAIN_SR
    os.makedirs(cfg["raw_data_dir"])
    secs = np.linspace(4.0, 12.0, TRAIN_CLIPS)
    for i, s in enumerate(secs):
        save_wav(synth.voiced_wav(float(s), sr, 150.0 + 8.0 * i, seed=i),
                 os.path.join(cfg["raw_data_dir"], f"clip{i:02d}.wav"), sr)
    res["audio_s"] = float(secs.sum())

    t0 = time.time()
    hp = set_hparams(config=cfg_fn, exp_name="smoke_train", reset=True,
                     print_hparams=False)
    binarize(hp, device=device)
    res["binarize_s"] = time.time() - t0
    lengths = np.load(os.path.join(cfg["binary_data_dir"],
                                   "train_lengths.npy"))
    log(f"[train] binarized {TRAIN_CLIPS} clips ({res['audio_s']:.1f} s) in "
        f"{res['binarize_s']:.2f}s; train split {len(lengths)} items, "
        f"{int(lengths.sum())} mel frames")
    if len(lengths) != TRAIN_CLIPS - 5:
        raise SmokeError(f"binarizer kept {len(lengths)} train items")

    # --- train through the entry point, K4's counter from the trainer alone
    hp = set_hparams(config=cfg_fn, exp_name="smoke_train", reset=True,
                     print_hparams=False)
    k4.launches = 0
    t0 = time.time()
    trainer = run_task(hp)
    torch.cuda.synchronize()
    res["fit_s"] = time.time() - t0
    res["launches"] = k4.launches
    losses = [h["loss"] for h in trainer.history]
    res["losses"] = losses
    log(f"[train] run_task: {trainer.global_step} steps in {res['fit_s']:.2f}s"
        f", losses {[round(x, 5) for x in losses]}, K4 launches "
        f"{k4.launches}")
    ckpts = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(hp["work_dir"], "*.ckpt")))
    res["checkpoints"] = ckpts
    if k4.launches <= 0:
        raise SmokeError("the trainer did not launch K4")
    if trainer.global_step != TRAIN_STEPS or len(losses) != TRAIN_STEPS \
            or not np.isfinite(losses).all():
        raise SmokeError(f"training: {trainer.global_step} steps, losses "
                         f"{losses}")
    if not 0.5 < losses[0] < 2.0:
        raise SmokeError(f"first loss {losses[0]} outside 0.5-2.0 (the zero "
                         "output head predicts zero noise)")
    want = [f"model_ckpt_steps_{s}.ckpt" for s in (VAL_EVERY, TRAIN_STEPS)]
    if ckpts != want:
        raise SmokeError(f"checkpoints {ckpts}, expected {want}")

    # --- restart from the step-3 checkpoint: state restored bit for bit
    work2 = os.path.join(workdir, "work_resume")
    os.makedirs(work2)
    shutil.copy(os.path.join(hp["work_dir"], want[0]), work2)
    hp2 = HParams(dict(hp, work_dir=work2))
    t2 = Trainer(hp2, device=device)
    if not t2.restore() or t2.global_step != VAL_EVERY \
            or t2.task.step != VAL_EVERY:
        raise SmokeError("no resume from the step-3 checkpoint")
    same = restored_bit_exact(t2.task, os.path.join(work2, want[0]))
    res["restore_bit_exact"] = bool(same)
    t2.fit()
    res["resumed_to"] = t2.global_step
    log(f"[train] resume from step {VAL_EVERY}: params + optimizer state "
        f"bit-exact {same}; trained on to step {t2.global_step}")
    if not same or t2.global_step != TRAIN_STEPS:
        raise SmokeError("resume: state not restored bit for bit, or did not "
                         "reach the last step")

    # --- one step twice from the same state, batch, t and noise
    ds = FastSpeechDataset("train", hp, shuffle=False)
    full = [b for b in build_batches(ds, hp, rng=np.random.RandomState(0))
            if len(b) == TRAIN_B][0]
    batch = next(iter(BatchIterator(ds, [full], pad_multiple=int(
        hp["frames_multiple"]))))
    task = t2.task
    g = torch.Generator().manual_seed(7)
    t = torch.randint(0, task.model.K_step, (TRAIN_B,), generator=g)
    noise = torch.randn(batch["mels"].shape, generator=g)
    snap = copy.deepcopy(task.state_dict())
    snap["global_step"] = task.step
    bundle = os.path.join(workdir, "det_step.pt")
    torch.save({"hp": dict(hp), "snap": snap, "batch": batch, "t": t,
                "noise": noise}, bundle)
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--deterministic-step", bundle],
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"),
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SmokeError(f"deterministic step: exit {proc.returncode}\n"
                         f"{proc.stderr[-3000:]}")
    det = json.loads(proc.stdout.strip().splitlines()[-1])
    res["step_deterministic"] = det
    log(f"[train] one step twice from the same state, batch, t, noise (child "
        f"process, deterministic algorithms): bit-identical params "
        f"{det['identical']}, K4 launches {det['launches']}")
    if not det["identical"] or det["launches"] <= 0:
        raise SmokeError(f"the same step twice gave different params, or "
                         f"did not run K4: {det}")

    task.load_state_dict(snap)
    if batch_route(hp, *batch["mels"].shape[:2]) != "batched":
        raise SmokeError("phase 5's step batch does not take K4's route")
    res["card_vs_plain"] = card_vs_plain_step(
        task, batch, t, noise, k4,
        [(k4, {"residual_stack_train_fwd": k4.residual_stack_train_fwd_plain,
               "residual_stack_train_batched_bwd":
               k4.residual_stack_train_batched_bwd_plain})],
        "residual_stack_train_batched_bwd", TRAIN_STEP_TOL)
    res["timing"] = time_train_steps(hp, device, batch)
    task.load_state_dict(snap)
    res["profile"] = profile_run(f"bf16 train step B={TRAIN_B} T="
                                 f"{batch['mels'].shape[1]}",
                                 lambda: task.train_step(batch))
    check_train_profile("phase 5's bf16 step (K4)", res["profile"].pop("names"),
                        "Bf16", "gate_tc_kernel<float>")
    del task, t2, trainer
    torch.cuda.empty_cache()

    # --- the trained checkpoint through the port's Svc
    ckpt = os.path.join(hp["work_dir"], want[1])
    svc = Svc("smoke_train", cfg_fn, True, ckpt, device=device)
    sd = strip_prefix(torch_load(ckpt)["state_dict"], "model.")
    if not all(torch.equal(v.cpu(), sd[k]) for k, v in
               svc.model.state_dict().items()):
        raise SmokeError("Svc did not load the trained weights")
    clip = os.path.join(workdir, "convert.wav")
    save_wav(synth.voiced_wav(6.0, sr, 220.0, [(2.5, 3.0)], seed=99), clip, sr)
    _, _, audio = infer_cli.run_clip(
        svc, key=0, acc=ACC, use_pe=False, use_crepe=False, thre=0.05,
        use_gt_mel=False, add_noise_step=500, file_path=clip,
        out_path=clip[:-4] + "_out.wav")
    src, _ = load_wav(clip)
    audio = np.asarray(audio, np.float32)
    res["svc"] = {"in_len": len(src), "out_len": len(audio),
                  "finite": bool(np.isfinite(audio).all())}
    log(f"[train] Svc with the step-{TRAIN_STEPS} checkpoint: {res['svc']}")
    if len(audio) != len(src) or not res["svc"]["finite"]:
        raise SmokeError(f"trained-checkpoint conversion: {res['svc']}")
    return res


# ---------------------------------------------------------------------------
# Phase 6: training at config_44k's own batch (max_sentences 88): K5's route
# ---------------------------------------------------------------------------

OWN_CLIPS, OWN_HELD_OUT = 96, 8   # 4-8 s clips; 88 train items: one batch
OWN_STEPS = 3
# One step at B=88 on the per-sample route (f32 streams), kernels vs plain
# versions on the card, as phase 5's check: sound 9.7e-6 on the H100; the
# planted fault, the last sample's cotangent dropped in K5's backward,
# reads 2.1e-2.
OWN_STEP_TOL = 1e-4


def own_batch_config(workdir: str, hubert_path: str, vocoder_ckpt: str):
    """config_44k at full width with base.yaml's batching (max_sentences 88,
    max_tokens 128000) and its default bf16 stream; every 12th clip held out
    for validation (B=1), so the train split is one batch of 88."""
    raw = os.path.join(workdir, "own_raw")
    return {"base_config": [os.path.join(ROOT, "configs", "config_44k.yaml")],
            "raw_data_dir": raw,
            "binary_data_dir": os.path.join(workdir, "own_bin"),
            "work_dir": os.path.join(workdir, "own_work"),
            "hubert_path": hubert_path, "vocoder_ckpt": vocoder_ckpt,
            "max_sentences": 88, "max_tokens": 128000,
            "diffnet_train_stream_dtype": "bf16",
            "max_updates": OWN_STEPS, "val_check_interval": 1000,
            "log_interval": 1, "num_valid_plots": 0, "use_crepe": False,
            "choose_test_manually": True,
            "test_prefixes": [os.path.join(raw, f"own{i:02d}") for i in
                              range(0, OWN_CLIPS, OWN_CLIPS // OWN_HELD_OUT)]}


def phase_train_own_batch(device, workdir, hubert_path, vocoder_ckpt):
    """96 synthetic clips of 4-8 s binarized by the port, then ``run_task``
    for 3 steps at config_44k's own batching: the batch of 88 must take the
    per-sample route (K5), K5's counter must equal the steps and K4's
    backward must not move, validation (B=1) runs K1; then ms/step,
    samples/s, mel frames/s and peak memory at B=88, and one step through
    the kernels against the plain versions on the card."""
    import numpy as np
    import torch
    import yaml

    from diffsvc_tpu_torch.config import set_hparams
    from diffsvc_tpu_torch.data.binarizer import binarize
    from diffsvc_tpu_torch.data.dataset import (BatchIterator,
                                                FastSpeechDataset,
                                                build_batches)
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as k1
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_per_sample as k5
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4
    from diffsvc_tpu_torch.run import run_task
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import save_wav

    res = {}
    cfg = own_batch_config(workdir, hubert_path, vocoder_ckpt)
    cfg_fn = os.path.join(workdir, "own.yaml")
    with open(cfg_fn, "w") as f:
        yaml.safe_dump(cfg, f)
    os.makedirs(cfg["raw_data_dir"])
    secs = np.linspace(4.0, 8.0, OWN_CLIPS)
    for i, sec in enumerate(secs):
        save_wav(synth.voiced_wav(float(sec), TRAIN_SR, 150.0 + 3.0 * i,
                                  seed=100 + i),
                 os.path.join(cfg["raw_data_dir"], f"own{i:02d}.wav"),
                 TRAIN_SR)
    t0 = time.time()
    hp = set_hparams(config=cfg_fn, exp_name="smoke_own", reset=True,
                     print_hparams=False)
    binarize(hp, device=device)
    res["binarize_s"] = time.time() - t0
    hp = set_hparams(config=cfg_fn, exp_name="smoke_own", reset=True,
                     print_hparams=False)
    ds = FastSpeechDataset("train", hp, shuffle=True)
    log(f"[own] binarized {OWN_CLIPS} clips ({float(secs.sum()):.1f} s) in "
        f"{res['binarize_s']:.2f}s; train split {len(ds)} items")
    if len(ds) != 88:
        raise SmokeError(f"train split of {len(ds)} items, expected 88")

    # the batches the trainer draws in its epochs, with their routes
    pad = int(hp["frames_multiple"])
    res["batches"] = []
    for epoch in range(OWN_STEPS):
        for idx in build_batches(ds, hp, rng=np.random.RandomState(
                int(hp["seed"]) + epoch)):
            b = len(idx)
            t = -(-int(max(ds.num_tokens(i) for i in idx)) // pad) * pad
            route = batch_route(hp, b, t)
            res["batches"].append({"epoch": epoch, "B": b, "T": t,
                                   "route": route})
            log(f"[own] epoch {epoch} batch: B={b} T={t} route {route}")
            if b != 88 or route != "per_sample":
                raise SmokeError(f"a batch of {b} on the {route} route; "
                                 "expected 88 on the per-sample route")

    # --- train through the entry point: K5 once per step, K4's backward
    # never, K1 for validation's primal
    k1.launches = k5.launches = k4.bwd_launches = 0
    t0 = time.time()
    trainer = run_task(hp, device=device)
    torch.cuda.synchronize()
    res["fit_s"] = time.time() - t0
    res["launches"] = {"residual_stack_train": k5.launches,
                       "residual_stack_train_batched (backward)":
                       k4.bwd_launches, "residual_stack": k1.launches}
    losses = [h["loss"] for h in trainer.history]
    res["losses"] = losses
    log(f"[own] run_task: {trainer.global_step} steps in {res['fit_s']:.2f}s"
        f", losses {[round(x, 5) for x in losses]}, launches "
        f"{res['launches']}")
    if trainer.global_step != OWN_STEPS or len(losses) != OWN_STEPS \
            or not np.isfinite(losses).all():
        raise SmokeError(f"training: {trainer.global_step} steps, losses "
                         f"{losses}")
    if k5.launches != OWN_STEPS or k4.bwd_launches != 0 or k1.launches <= 0:
        raise SmokeError(f"launches on the per-sample route: "
                         f"{res['launches']}")

    # --- the step's cost at B=88, and the card against the plain versions
    task = trainer.task
    batch = next(iter(BatchIterator(ds, [list(range(len(ds)))],
                                    pad_multiple=pad)))
    res["timing"] = dict(time_steps(task, batch, reps=2),
                         route=batch_route(hp, *batch["mels"].shape[:2]))
    log_steps("own", f"bf16 config, {res['timing']['route']} route", batch,
              res["timing"])
    res["profile"] = profile_run(f"train step B={len(ds)} T="
                                 f"{batch['mels'].shape[1]} (K5)",
                                 lambda: task.train_step(batch))
    check_train_profile("phase 6's step at B=88 (K5)",
                        res["profile"].pop("names"), "Tf32x3",
                        "tf32x3::gate_kernel")
    g = torch.Generator().manual_seed(8)
    t = torch.randint(0, task.model.K_step, (len(ds),), generator=g)
    noise = torch.randn(batch["mels"].shape, generator=g)
    res["card_vs_plain"] = card_vs_plain_step(
        task, batch, t, noise, k5,
        [(k4, {"residual_stack_train_fwd": k4.residual_stack_train_fwd_plain}),
         (k5, {"residual_stack_train_bwd": k5.residual_stack_train_bwd_plain})],
        "residual_stack_train_bwd", OWN_STEP_TOL, tag="own")
    del task, trainer
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 8: the rest of conversion (DDPM, CREPE, the 24 kHz profile)
# ---------------------------------------------------------------------------

# a voiced clip of 3 s with no silence: one chunk (two fused buckets)
DDPM_CLIP = (3.0, 262.0, [])
# the card-vs-CPU DDPM check: use_gt_mel from the input's mel q-sampled to
# step 49, then 50 DDPM steps, on 0.5 s
DDPM_CPU_STEPS = 50
# CREPE's card-vs-CPU check: its posteriors on this block of frames of the
# 14 s clip (the CPU's network costs ~2.8 GFLOP a frame)
CREPE_BLOCK = (1000, 1128)
# the network's posteriors, card against CPU, both true f32 (cuDNN's
# convolutions against MKL-DNN's, 6 layers, f32 sums in other orders)
CREPE_TOL = 1e-4
# pe on the 14 s clip's mel, card against CPU, both true f32
PE_TOL = 1e-4
BINARIZE_CLIPS = 6     # the binarizer keeps 1 as train, 5 as valid = test


def clip_checks(label, audio, src_len):
    """Length of the input, finite, not silent."""
    import numpy as np

    audio = np.asarray(audio, np.float32)
    peak = float(np.abs(audio).max()) if len(audio) else 0.0
    if len(audio) != src_len or not np.isfinite(audio).all() or peak < 1e-3:
        raise SmokeError(f"{label}: output of {len(audio)} samples (input "
                         f"{src_len}), finite {np.isfinite(audio).all()}, "
                         f"peak {peak}")
    return peak


def ddpm_step_times(svc, wav_fn) -> dict:
    """Sampling alone at acc=1 on the clip's batch (``model.infer``): wall
    per step (host clock ending in a sync) and, from a profiled run, the
    device kernels per step and the device busy time per step."""
    import numpy as np
    import torch

    k_step = svc.model.K_step
    b = svc.pre(wav_fn, 1, use_crepe=False)
    tb = {k: torch.from_numpy(np.asarray(b[k])).to(svc.device)
          for k in ("hubert", "mels", "mel2ph", "energy", "f0", "uv")}
    torch.cuda.synchronize()
    t0 = time.time()
    svc.model.infer(tb, speedup=1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    prof = profile_run(f"{svc.hp['diff_compute_dtype'] or 'float32'} DDPM "
                       f"sampling, {k_step} steps at T={b['mels'].shape[1]}",
                       lambda: svc.model.infer(tb, speedup=1))
    return {"frames": int(b["mels"].shape[1]), "steps": k_step,
            "ms_per_step": wall * 1e3 / k_step,
            "launches_per_step": prof["device_events"] / k_step,
            "device_ms_per_step": prof["device_busy_ms"] / k_step,
            "busy_share": prof["busy_share"]}


def phase_ddpm(project, workdir, launches):
    """(a) DDPM at acc=1 on phase 4's project: a 3 s clip through run_clip,
    modular and fused graph, in bf16 and f32 (K1 one launch per step, K2
    none); ms per step, launches per step, RTF, the acc=1 bucket's capture
    and pool; a 0.5 s conversion card vs CPU with use_gt_mel at 50 steps."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch import infer_cli
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import load_wav, save_wav

    secs, f0, gaps = DDPM_CLIP
    wav_fn = os.path.join(workdir, "ddpm_clip.wav")
    save_wav(synth.voiced_wav(secs, 44100, f0, gaps, seed=8), wav_fn, 44100)
    src_len = len(load_wav(wav_fn)[0])
    n_chunks = len(voiced_chunks(wav_fn))
    res = {"clip_s": secs, "chunks": n_chunks}
    for dt, svc in project["svcs"].items():
        name = dt or "float32"
        k_step = svc.model.K_step
        rec = res.setdefault(name, {})
        for route, kw in (("modular", {}), ("fused graph", {"fused": True})):
            label = f"DDPM {route} {name}"
            with counted(label, launches, moved=("residual_stack",
                                                 "vocoder_tail"),
                         still=("plms_ladder",), tag="rest"):
                torch.cuda.synchronize()
                t0 = time.time()
                _, _, audio = infer_cli.run_clip(
                    svc, key=0, acc=1, use_pe=False, use_crepe=False,
                    thre=0.05, use_gt_mel=False, add_noise_step=500,
                    file_path=wav_fn, out_path=wav_fn[:-4] + "_ddpm.wav",
                    **kw)
                torch.cuda.synchronize()
                wall = time.time() - t0
            k1 = launches[label]["residual_stack"]
            # a fused bucket's first call warms up once and captures: K1
            # runs the trajectory once more per new bucket
            calls = k1 / k_step
            if k1 % k_step or calls < n_chunks:
                raise SmokeError(f"{label}: K1 launched {k1} times for "
                                 f"{n_chunks} chunks of {k_step} steps")
            rec[route] = {"wall_s": wall, "rtf": wall / secs,
                          "peak": clip_checks(label, audio, src_len),
                          "k1_launches": k1, "trajectories": calls}
        # ms per step: the modular sampler alone, and a fused graph replay
        rec["sampling"] = ddpm_step_times(svc, wav_fn)
        fused = svc.fused_model(1)
        chunk = voiced_chunks(wav_fn)[0]
        svc.infer_fused(chunk, key=0, acc=1)
        torch.cuda.synchronize()
        t0 = time.time()
        svc.infer_fused(chunk, key=0, acc=1)
        torch.cuda.synchronize()
        rec["fused_chunk_ms_per_step"] = (time.time() - t0) * 1e3 / k_step
        prof = profile_run(f"{name} DDPM fused graph replay, one chunk",
                           lambda: svc.infer_fused(chunk, key=0, acc=1))
        rec["fused_launches_per_step"] = prof["device_events"] / k_step
        rec["captures"] = {str(k[:2]): {"warmup_s": w, "capture_s": c,
                                        "pool_mib": fused.pool_bytes()[k]
                                        / 2 ** 20}
                           for k, (w, c) in fused.capture_seconds().items()}
        # each route again, warm (packs built, the bucket captured)
        for route, kw in (("modular", {}), ("fused graph", {"fused": True})):
            torch.cuda.synchronize()
            t0 = time.time()
            infer_cli.run_clip(svc, key=0, acc=1, use_pe=False,
                               use_crepe=False, thre=0.05, use_gt_mel=False,
                               add_noise_step=500, file_path=wav_fn,
                               out_path=wav_fn[:-4] + "_ddpm.wav", **kw)
            torch.cuda.synchronize()
            rec[route]["rtf_warm"] = (time.time() - t0) / secs
        smp = rec["sampling"]
        log(f"[rest] DDPM {name}: {secs:.1f}s clip ({n_chunks} chunk) RTF "
            f"modular {rec['modular']['rtf']:.4f} (warm "
            f"{rec['modular']['rtf_warm']:.4f}), fused graph "
            f"{rec['fused graph']['rtf_warm']:.4f} (first, with its "
            f"captures, {rec['fused graph']['rtf']:.4f}); sampling alone "
            f"{smp['ms_per_step']:.4f} ms/step at T={smp['frames']}, "
            f"{smp['launches_per_step']:.1f} launches/step, device "
            f"{smp['device_ms_per_step']:.4f} ms/step (busy share "
            f"{smp['busy_share']:.3f}); fused chunk replay "
            f"{rec['fused_chunk_ms_per_step']:.4f} ms/step, "
            f"{rec['fused_launches_per_step']:.1f} device events/step; "
            "captures "
            f"{ {k: {kk: round(vv, 3) for kk, vv in v.items()} for k, v in rec['captures'].items()} }")
        # the denoiser's part of this waveform is ~5e-4 of it, below what
        # the AC tracker's device difference moves: the CPU's track on both
        # sides (phase 4 holds the card's tracker, at acc=20)
        rec["cpu_agreement"] = cpu_agreement(
            svc, project["cfg_fn"], project["ckpt"], project["wavs"][0],
            acc=1, tag="DDPM", same_f0=True, use_gt_mel=True,
            add_noise_step=DDPM_CPU_STEPS)
    return res


def crepe_binarize_tags(device, project, workdir, crepe_path):
    """Binarize config_44k as shipped (``use_crepe: true``) on a few clips,
    with CREPE's weights at ``crepe_path`` and without: the tracker each
    item used."""
    import numpy as np
    import yaml

    from diffsvc_tpu_torch.config import set_hparams
    from diffsvc_tpu_torch.data import features
    from diffsvc_tpu_torch.data.binarizer import binarize
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import save_wav

    with open(project["cfg_fn"]) as f:
        proj = yaml.safe_load(f)
    raw = os.path.join(workdir, "raw_crepe")
    os.makedirs(raw)
    for i in range(BINARIZE_CLIPS):
        save_wav(synth.voiced_wav(2.0, 44100, 180.0 + 20 * i, seed=20 + i),
                 os.path.join(raw, f"c{i}.wav"), 44100)
    real, tags = features.get_pitch, {}
    out = {}
    for have in (True, False):
        label = "with weights" if have else "without weights"
        cfg = {"base_config": [os.path.join(ROOT, "configs",
                                            "config_44k.yaml")],
               "raw_data_dir": raw,
               "binary_data_dir": os.path.join(workdir, f"bin_{int(have)}"),
               "hubert_path": proj["hubert_path"],
               "vocoder_ckpt": proj["vocoder_ckpt"],
               "crepe_path": crepe_path if have else
               os.path.join(workdir, "no_crepe", "full.pth")}
        cfg_fn = os.path.join(workdir, f"crepe_{int(have)}.yaml")
        with open(cfg_fn, "w") as f:
            yaml.safe_dump(cfg, f)
        hp = set_hparams(config=cfg_fn, exp_name="smoke_crepe", reset=True,
                         print_hparams=False)
        if not hp["use_crepe"]:
            raise SmokeError("config_44k as shipped does not ask for CREPE")
        got = tags.setdefault(label, [])

        def spy(*args, **kw):
            f0, coarse, tag = real(*args, **dict(kw, return_tag=True))
            got.append(tag)
            return f0, coarse

        features.get_pitch = spy
        try:
            t0 = time.time()
            binarize(hp, device=device)
            secs = time.time() - t0
        finally:
            features.get_pitch = real
        lengths = np.load(os.path.join(cfg["binary_data_dir"],
                                       "train_lengths.npy"))
        want = "crepe" if have else "ac"
        out[label] = {"tags": got, "binarize_s": secs,
                      "train_items": int(len(lengths))}
        log(f"[rest] binarize config_44k as shipped ({BINARIZE_CLIPS} clips, "
            f"{label}): f0 trackers {got}, {len(lengths)} train items, "
            f"{secs:.2f}s")
        # the valid and test splits are the same items: each is tracked
        # once per split it is in
        if len(got) < BINARIZE_CLIPS or set(got) != {want} or \
                len(lengths) < 1:
            raise SmokeError(f"binarize {label}: trackers {got} (want "
                             f"{want} for every item)")
    return out


def phase_crepe(device, project, workdir):
    """(b) CREPE on the card: the 14 s clip through get_pitch (network,
    Viterbi), its parts timed; posteriors card vs CPU on a block of frames;
    the binarizer on config_44k as shipped, with and without weights."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.data import features
    from diffsvc_tpu_torch.ops import crepe
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import load_wav, resample

    path = os.path.join(workdir, "crepe", "full.pth")
    synth.write_crepe(path, seed=4)
    model = crepe.load_crepe(path, device)
    wav, sr = load_wav(project["wavs"][-1])
    hp = dict(project["svcs"][""].hp, crepe_path=path)
    mel = np.zeros((1 + len(wav) // int(hp["hop_size"]), 1), np.float32)
    # the first call of the process on 1 s: cuDNN's benchmark chooses the
    # network's algorithms for its one chunk shape
    torch.cuda.synchronize()
    t0 = time.time()
    features.get_pitch(wav[: sr], mel[: 1 + sr // int(hp["hop_size"])], hp,
                       True, device=device)
    torch.cuda.synchronize()
    first_ms = (time.time() - t0) * 1e3
    t0 = time.time()
    f0, _, tag = features.get_pitch(wav, mel, hp, True, device=device,
                                    return_tag=True)
    torch.cuda.synchronize()
    total_ms = (time.time() - t0) * 1e3
    wav16 = torch.from_numpy(resample(wav, sr, crepe.SR)).to(device)
    frames = crepe.frame_audio(wav16)
    net_ms = cuda_time_ms(lambda: crepe.posteriors(model, frames), reps=3)
    probs = crepe.posteriors(model, frames)
    torch.cuda.synchronize()
    t0 = time.time()
    crepe._viterbi(probs)
    torch.cuda.synchronize()
    viterbi_ms = (time.time() - t0) * 1e3
    n = int(frames.shape[0])
    flops = 0.0
    t_len, c_in = crepe.WINDOW, 1
    for f, k, st in zip(crepe.FILTERS, crepe.KERNELS, crepe.STRIDES):
        t_len = t_len // st
        flops += 2.0 * c_in * f * k * t_len
        t_len, c_in = t_len // 2, f
    flops = n * (flops + 2.0 * 2048 * crepe.N_BINS)
    # the posteriors of a block, card against CPU, and the f0 each decodes
    lo, hi = CREPE_BLOCK
    cpu = crepe.load_crepe(path, "cpu")
    ref = crepe.posteriors(cpu, frames[lo:hi].cpu())
    got = probs[lo:hi]
    rel = rel_l2(got.cpu(), ref)
    f0_dev = crepe.decode(got)[0].cpu()
    f0_cpu = crepe.decode(ref)[0]
    agree = float(((f0_dev - f0_cpu).abs() <= 1e-4 * f0_cpu).double().mean())
    res = {"tag": tag, "frames": n, "ms": total_ms, "first_call_1s_ms":
           first_ms, "network_ms": net_ms,
           "viterbi_ms": viterbi_ms, "network_flops": flops,
           "network_bound_ms": bound(flops, nbytes(frames, probs),
                                     "f32")["bound_ms"],
           "voiced_share": float((f0 > 0).mean()),
           "posteriors_rel_l2": rel, "tol_rel_l2": CREPE_TOL,
           "f0_agree_share": agree, "block": [lo, hi]}
    log(f"[rest] CREPE on the {len(wav) / sr:.1f}s clip ({n} frames): "
        f"get_pitch {total_ms:.1f} ms (tracker {tag}), of which the network "
        f"{net_ms:.1f} ms ({flops / 1e12:.2f} TFLOP; bound at the CUDA "
        f"cores' f32 rate {res['network_bound_ms']:.1f} ms) and the Viterbi "
        f"{viterbi_ms:.1f} ms ({n - 1} sequential steps on the card, "
        f"traced back on the host); voiced {res['voiced_share']:.3f}; the "
        f"process's first call, on 1 s, with cuDNN's benchmark: "
        f"{first_ms:.1f} ms")
    log(f"[rest] CREPE posteriors card vs CPU on frames {lo}-{hi}: rel_l2 "
        f"{rel:.3e} (tol {CREPE_TOL:g}); f0 decoded on each side agrees to "
        f"1e-4 on {agree:.4f} of the frames")
    if tag != "crepe":
        raise SmokeError(f"CREPE with weights gave the {tag} tracker")
    if not rel <= CREPE_TOL:
        raise SmokeError(f"CREPE's posteriors disagree card vs CPU: {rel}")
    res["binarize"] = crepe_binarize_tags(device, project, workdir, path)
    return res


def phase_24k(device, workdir, launches):
    """(c) A config_24k project at full width (DiffNet 256 x 20, 80 mel,
    HuBERT-soft 768 x 12, pe, HiFi-GAN V1, ContentVec 768 x 12): the 14 s
    clip through the modular (pe), batched (pe) and fused-graph routes in
    bf16 and f32 (K2 and K3 moving on each), card vs CPU at phase 4's limits
    with a planted fault, pe's time and card-vs-CPU agreement, ContentVec's
    time beside HuBERT-soft's and one conversion through it."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch import infer_cli
    from diffsvc_tpu_torch.infer.hubert_encoder import Hubertencoder
    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.models import pe as pe_model
    from diffsvc_tpu_torch.models.hubert import HubertConfig
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import load_wav, save_wav

    sr = 24000
    t0 = time.time()
    cfg_fn, ckpt = synth.write_project(
        os.path.join(workdir, "proj24"),
        {"base_config": [os.path.join(ROOT, "configs", "config_24k.yaml")]},
        VOC24_H, hubert_cfg=HubertConfig(), pe=True,
        vec_cfg=HubertConfig())
    log(f"[rest] wrote the config_24k project in {time.time() - t0:.2f}s")
    secs, f0, gaps = CLIPS[SERVE_CLIP]
    wav_fn = os.path.join(workdir, "clip24.wav")
    save_wav(synth.voiced_wav(secs, sr, f0, gaps, seed=2), wav_fn, sr)
    short = os.path.join(workdir, "clip24_short.wav")
    save_wav(synth.voiced_wav(2.0, sr, f0, seed=3), short, sr)
    src_len = len(load_wav(wav_fn)[0])
    n_chunks = len(voiced_chunks(wav_fn))
    res = {"routes": {}}
    svcs = {}
    for dt in ("bfloat16", ""):
        svcs[dt] = Svc("proj24", cfg_fn, True, ckpt, device=device)
        svcs[dt].hp["diff_compute_dtype"] = dt
        if svcs[dt].pe is None:
            raise SmokeError("the config_24k project's pe did not load")
        svcs[dt].infer(short, key=0, acc=ACC, use_pe=True, use_crepe=False)

    def clip(svc, **route):
        return infer_cli.run_clip(
            svc, key=0, acc=ACC, use_pe=True, use_crepe=False, thre=0.05,
            use_gt_mel=False, add_noise_step=500, file_path=wav_fn,
            out_path=wav_fn[:-4] + "_out.wav", **route)

    for dt, svc in svcs.items():
        name = dt or "float32"
        routes = res["routes"].setdefault(name, {})
        for route, kw in (("modular", {}), ("batched",
                                            {"batch_chunks": True}),
                          ("fused graph", {"fused": True})):
            label = f"24k {route} {name}"
            with counted(label, launches, tag="rest"):
                _, _, audio = clip(svc, **kw)
            clip_checks(label, audio, src_len)
            pools = sum(svc.fused_model(ACC).pool_bytes().values()) \
                if "fused" in kw else 0
            routes[route] = route_run(f"24k {route} {name}", secs, n_chunks,
                                      lambda kw=kw: clip(svc, **kw), pools)
        res.setdefault("cpu_agreement", {})[name] = cpu_agreement(
            svc, cfg_fn, ckpt, wav_fn, tag="24k")
    # pe on the clip's mel: time, and card against CPU
    svc = svcs[""]
    b = svc.pre(wav_fn, ACC, use_crepe=False)
    mel = torch.from_numpy(np.asarray(b["mels"])).to(device)
    pe_ms = cuda_time_ms(lambda: svc.pe(mel), reps=5)
    pe_cpu = pe_model.load(svc.hp["pe_ckpt"], svc.hp, "cpu")
    pe_rel = rel_l2(svc.pe(mel)["pitch_pred"].cpu(),
                    pe_cpu(mel.cpu())["pitch_pred"])
    res["pe"] = {"ms": pe_ms, "frames": int(mel.shape[1]),
                 "rel_l2": pe_rel, "tol_rel_l2": PE_TOL}
    log(f"[rest] pe on the {secs:.1f}s clip's mel ({mel.shape[1]} frames): "
        f"{pe_ms:.3f} ms; card vs CPU rel_l2 {pe_rel:.3e} (tol {PE_TOL:g})")
    if not pe_rel <= PE_TOL:
        raise SmokeError(f"pe disagrees card vs CPU: {pe_rel}")
    # ContentVec beside HuBERT-soft, then one conversion through it
    vec = Hubertencoder(svc.hp["hubert_path"],
                        hp=dict(svc.hp, use_vec=True), device=device)
    wav16, _ = load_wav(wav_fn, sr=16000)
    times = {}
    for label, enc in (("hubert_soft", svc.hubert), ("contentvec", vec)):
        enc.encode(wav16[:32000])
        times[label] = cuda_time_ms(lambda enc=enc: enc.encode(wav16),
                                    reps=3)
    res["encoders_ms"] = times
    svc.hubert = vec
    with counted("24k modular float32 ContentVec", launches, tag="rest"):
        _, _, audio = clip(svc)
    res["contentvec_peak"] = clip_checks("24k ContentVec", audio, src_len)
    log(f"[rest] content encoders on the {secs:.1f}s clip: HuBERT-soft "
        f"{times['hubert_soft']:.2f} ms, ContentVec {times['contentvec']:.2f}"
        " ms (layer 9 of 12); a modular conversion through ContentVec passed"
        " its output checks")
    return res


def phase_rest(device, project, workdir):
    """Phase 8 on phase 4's project, a CREPE checkpoint and a config_24k
    project."""
    launches = {}
    res = {"ddpm": phase_ddpm(project, workdir, launches),
           "crepe": phase_crepe(device, project, workdir),
           "24k": phase_24k(device, workdir, launches)}
    res["launches"] = launches
    return res


# ---------------------------------------------------------------------------
# Phase 9: the rest of single-card training and the data inventory
# ---------------------------------------------------------------------------

RADAM_STEPS = 7          # b2 = 0.98: steps 6 and 7 take the rectified branch
# The port's RAdam (in-place updates on the card) against optax's update
# written out on whole tensors on the card, steps 1-7 on fixed grads:
# rel-L2 of the parameters' total update.  The planted fault drops the
# rectification term (r_t = 1), i.e. Adam's update from step 6.
RADAM_TOL = 1e-6
# One pe step against the same step in float64 on the CPU (the same init
# and batch): the loss and each parameter's grad, rel-L2.  The grads are
# read on pe's smooth twin (every ReLU as softplus(x, beta=50), the f64
# step likewise): with ReLU, an input within rounding of 0 takes the other
# branch in f32 than in f64 and passes the whole upstream grad, which
# reads 3e-5 to 5e-4 on the card and on the CPU alike, moving with the
# init seed; the smooth twin reads the arithmetic, 1.3e-5 on the H100
# (1.6e-5 on the CPU; tools/pe_step_error.py).  The planted fault leaves
# pe's convolutions at cuDNN's default TF32 (2.8e-3 to 9.0e-3).
PE_STEP_TOL = 1e-4
PE_CLIPS, PE_SR = 16, 24000      # synthetic clips of 3-6 s for the pe task


def radam_plain(p0, grads, lrs, b1, b2, eps=1e-8, threshold=5.0):
    """optax.radam's update written out on whole tensors, step by step."""
    p, m, v = p0.clone(), 0.0 * p0, 0.0 * p0
    rho_inf = 2.0 / (1.0 - b2) - 1.0
    for t, (g, lr) in enumerate(zip(grads, lrs), start=1):
        m = (1.0 - b1) * g + b1 * m
        v = (1.0 - b2) * g * g + b2 * v
        m_hat, v_hat = m / (1.0 - b1 ** t), v / (1.0 - b2 ** t)
        rho = rho_inf - 2.0 * t * b2 ** t / (1.0 - b2 ** t)
        if rho >= threshold:
            r = ((rho - 4.0) * (rho - 2.0) * rho_inf
                 / ((rho_inf - 4.0) * (rho_inf - 2.0) * rho)) ** 0.5
            m_hat = r * m_hat / (v_hat.sqrt() + eps)
        p = p - lr * m_hat
    return p


def radam_vs_plain(task) -> dict:
    """The task's RAdam on the card, 7 steps on fixed random grads at the
    task's schedule over as many values as the task has parameters, against
    :func:`radam_plain`; and with the rectification dropped.  The values
    start at 0 (RAdam's update does not read them), so the check reads the
    update itself: from the trained parameters, their own rounding at each
    step (an ulp of ~0.05 is ~1e-6 of a 7-step update) would read 1.7e-6
    on the H100."""
    import torch

    from diffsvc_tpu_torch.training import task as task_mod

    b1, b2 = task.optimizer.param_groups[0]["betas"]
    p0 = torch.zeros(sum(p.numel() for p in task.params),
                     device=task.params[0].device)
    g = torch.Generator(device=p0.device).manual_seed(3)
    grads = [torch.randn(p0.shape, generator=g, device=p0.device) * 1e-3
             for _ in range(RADAM_STEPS)]
    lrs = [task.lr_schedule(s) for s in range(RADAM_STEPS)]

    def port():
        p = torch.nn.Parameter(p0.clone())
        opt = task_mod.RAdam([p], lr=lrs[0], betas=(b1, b2))
        for grad, lr in zip(grads, lrs):
            p.grad = grad.clone()
            opt.param_groups[0]["lr"] = lr
            opt.step()
        return p.detach()

    ref = radam_plain(p0, grads, lrs, b1, b2) - p0
    rel = rel_l2(port() - p0, ref)
    rect = task_mod.rectification
    with swapped(task_mod, rectification=lambda t, b2, th=5.0: (
            None if rect(t, b2, th) is None else 1.0)):
        fault = rel_l2(port() - p0, ref)
    res = {"rel_l2": rel, "fault_rel_l2": fault, "tol": RADAM_TOL,
           "params": int(p0.numel()), "steps": RADAM_STEPS}
    log(f"[train2] RAdam on the card vs optax's update written out, steps "
        f"1-{RADAM_STEPS} on {p0.numel()} parameters: rel_l2 {rel:.3e} (tol "
        f"{RADAM_TOL:g}); planted fault [rectification dropped: "
        f"{fault:.3e}]")
    if not rel <= RADAM_TOL:
        raise SmokeError(f"RAdam disagrees with optax's formula: {res}")
    if not fault > RADAM_TOL:
        raise SmokeError(f"the planted RAdam fault passes: {res}")
    return res


def update_ms(task) -> dict:
    """Device time of one optimizer update alone on copies of the task's
    parameters with fixed grads: the port's RAdam beside the AdamW that
    the task builds otherwise (PyTorch's multi-tensor path)."""
    import torch

    from diffsvc_tpu_torch.training.task import RAdam

    g = torch.Generator(device=task.params[0].device).manual_seed(4)
    params = [torch.nn.Parameter(p.detach().clone()) for p in task.params]
    for p in params:
        p.grad = torch.randn(p.shape, generator=g, device=p.device) * 1e-3
    lr, betas = task.lr_schedule(0), task.optimizer.param_groups[0]["betas"]
    opts = {"radam": RAdam(params, lr=lr, betas=betas, eps=1e-8),
            "adamw": torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                       weight_decay=0.0)}
    res = {name: cuda_time_ms(opt.step, reps=10) for name, opt in
           opts.items()}
    log(f"[train2] one optimizer update alone on {len(params)} tensors "
        f"({sum(p.numel() for p in params)} values): RAdam "
        f"{res['radam']:.3f} ms, AdamW {res['adamw']:.3f} ms")
    return res


def restored_bit_exact(task, ckpt_fn) -> bool:
    """Params and every optimizer state tensor of ``task`` equal the
    checkpoint's, bit for bit."""
    import torch

    from diffsvc_tpu_torch.utils.convert import torch_load

    saved = torch_load(ckpt_fn)
    now = task.state_dict()
    same = all(torch.equal(v, now["state_dict"][k])
               for k, v in saved["state_dict"].items())
    o_saved = saved["optimizer_states"][0]["state"]
    o_now = task.optimizer.state_dict()["state"]
    return same and len(o_saved) == len(o_now) > 0 and all(
        torch.equal(v.cpu(), o_now[i][k].cpu())
        for i, st in o_saved.items() for k, v in st.items())


def step_batch(hp):
    """The largest training batch of the config's batching, as the trainer
    feeds it (with its ``sample_mask``)."""
    import numpy as np

    from diffsvc_tpu_torch.data.dataset import (BatchIterator,
                                                FastSpeechDataset,
                                                _pad_batch_dim, build_batches)

    ds = FastSpeechDataset("train", hp, shuffle=False)
    full = max(build_batches(ds, hp, rng=np.random.RandomState(0)), key=len)
    batch = next(iter(BatchIterator(ds, [full], pad_multiple=int(
        hp["frames_multiple"]))))
    return _pad_batch_dim(batch, batch["nsamples"])


def phase_radam(device, workdir, cfg_fn, launches):
    """(a) ``optimizer: radam`` through run_task for 7 steps at phase 5's
    batching (bf16 stream, K4; validation's loss on K1, once per
    validation batch), the update against optax's formula on the card with
    its fault, a restart from step 3, ms per step."""
    import shutil

    import numpy as np
    import torch

    from diffsvc_tpu_torch.config import HParams, set_hparams
    from diffsvc_tpu_torch.run import run_task
    from diffsvc_tpu_torch.training.task import RAdam, SVCTask
    from diffsvc_tpu_torch.training.trainer import Trainer

    hp = HParams(dict(set_hparams(config=cfg_fn, exp_name="smoke_radam",
                                  reset=True, print_hparams=False),
                      optimizer="radam", max_updates=RADAM_STEPS,
                      work_dir=os.path.join(workdir, "work_radam")))
    res = {}
    val_calls = {"n": 0}
    val_step = SVCTask.val_step

    def counting_val_step(self, batch):
        val_calls["n"] += 1
        return val_step(self, batch)

    label = "radam run_task"
    t0 = time.time()
    with swapped(SVCTask, val_step=counting_val_step), \
            counted(label, launches, tag="train2",
                    moved=("residual_stack_train_batched", "residual_stack"),
                    still=("plms_ladder", "vocoder_tail",
                           "residual_stack_train", "fused_residual_block")):
        trainer = run_task(hp)
    res["fit_s"] = time.time() - t0
    counts = launches[label]
    res["launches"] = counts
    res["val_steps"] = val_calls["n"]
    losses = [h["loss"] for h in trainer.history]
    res["losses"] = losses
    log(f"[train2] radam run_task: {trainer.global_step} steps in "
        f"{res['fit_s']:.2f}s, losses {[round(x, 5) for x in losses]}, K4 "
        f"launches {counts['residual_stack_train_batched']}, K1 "
        f"{counts['residual_stack']} for {val_calls['n']} validation "
        f"batches; optimizer {type(trainer.task.optimizer).__name__}")
    if not isinstance(trainer.task.optimizer, RAdam) \
            or len(losses) != RADAM_STEPS or not np.isfinite(losses).all() \
            or counts["residual_stack"] != val_calls["n"]:
        raise SmokeError(f"radam training: {res}")
    res["vs_plain"] = radam_vs_plain(trainer.task)
    # a restart from the step-3 checkpoint, then on to the last step
    ckpt3 = os.path.join(hp["work_dir"], f"model_ckpt_steps_{VAL_EVERY}.ckpt")
    work2 = os.path.join(workdir, "work_radam_resume")
    os.makedirs(work2)
    shutil.copy(ckpt3, work2)
    t2 = Trainer(HParams(dict(hp, work_dir=work2)), device=device)
    same = t2.restore() and t2.task.step == VAL_EVERY \
        and restored_bit_exact(t2.task, ckpt3)
    t2.fit()
    res["restore_bit_exact"] = bool(same)
    log(f"[train2] radam resume from step {VAL_EVERY}: params + optimizer "
        f"state bit-exact {same}; trained on to step {t2.global_step}")
    if not same or t2.global_step != RADAM_STEPS:
        raise SmokeError("radam resume: state not restored bit for bit")
    batch = step_batch(hp)
    res["timing"] = time_steps(t2.task, batch, reps=3)
    log_steps("train2", "radam, bf16 streams", batch, res["timing"])
    res["update_ms"] = update_ms(t2.task)
    del trainer, t2
    torch.cuda.empty_cache()
    return res


def pe_config(workdir: str) -> dict:
    """config_24k (pe at its width: hidden 256, 2 conv layers, 80 mel) on
    16 synthetic clips, the AC tracker, the pe task."""
    return {"base_config": [os.path.join(ROOT, "configs", "config_24k.yaml")],
            "raw_data_dir": os.path.join(workdir, "raw24"),
            "binary_data_dir": os.path.join(workdir, "bin24"),
            "work_dir": os.path.join(workdir, "work_pe"),
            "hubert_path": os.path.join(workdir, "hubert", "hubert_soft.pt"),
            "task_cls": "training.pe.PitchExtractionTask",
            "max_sentences": 8, "max_updates": 4, "val_check_interval": 4,
            "log_interval": 1, "num_valid_plots": 0, "use_crepe": False}


@contextlib.contextmanager
def smooth_relus():
    """Every ReLU of pe (``torch.relu`` and ``nn.ReLU``'s ``F.relu``) as
    ``softplus(x, beta=50)`` inside the block."""
    import torch
    import torch.nn.functional as F

    def soft(x, inplace=False):
        return F.softplus(x, beta=50.0)

    with swapped(torch, relu=soft), swapped(F, relu=soft):
        yield


def pe_step(hp, batch, device, f64=False, seed=None):
    """(loss, grads) of one pe step from the task's init (or the init of
    ``seed``), on the CPU as float64 tensors; with ``f64`` the step itself
    runs in float64."""
    from diffsvc_tpu_torch.training.pe_task import PitchExtractionTask

    task = PitchExtractionTask(hp, device=device)
    if seed is not None:
        task.init_state(seed)
    if f64:
        task.model.double()
    loss, _, grads = task.loss_and_grads(batch)
    return loss.cpu().double().reshape(1), [g.cpu().double() for g in grads]


def write_pe_data(workdir: str) -> str:
    """:func:`pe_config`'s yaml and its 16 clips of 3-6 s at 24 kHz; the
    config's path."""
    import numpy as np
    import yaml

    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import save_wav

    cfg = pe_config(workdir)
    cfg_fn = os.path.join(workdir, "pe.yaml")
    with open(cfg_fn, "w") as f:
        yaml.safe_dump(cfg, f)
    os.makedirs(cfg["raw_data_dir"])
    for i, s in enumerate(np.linspace(3.0, 6.0, PE_CLIPS)):
        save_wav(synth.voiced_wav(float(s), PE_SR, 140.0 + 15.0 * i,
                                  [(1.0, 1.3)], seed=50 + i),
                 os.path.join(cfg["raw_data_dir"], f"pe{i:02d}.wav"), PE_SR)
    return cfg_fn


def pe_step_vs_f64(hp, device, batch) -> dict:
    """One pe step's loss and every parameter's grad, the card's and the
    CPU's, each against the same step in float64 on the CPU; the gate on
    the card's loss and on its smooth twin's loss and grads (see
    PE_STEP_TOL), and the card's step time.  The card's steps run under
    PyTorch's default ``cudnn.allow_tf32`` (True), as a user's training
    does: the task itself must keep its forward and backward convolutions
    true f32."""
    import torch

    from diffsvc_tpu_torch.models import nn as fnn
    from diffsvc_tpu_torch.training.pe_task import PitchExtractionTask

    names = PitchExtractionTask(hp, device="cpu").names

    def read(run, ref):
        rels = sorted(((rel_l2(a, b), n) for n, a, b in
                       zip(names, run[1], ref[1])), reverse=True)
        return {"loss": rel_l2(run[0], ref[0]), "grad": rels[0][0],
                "worst": [(n, r) for r, n in rels[:3]]}

    res = {}
    for smooth in (False, True):
        tag = "smooth" if smooth else "relu"
        with smooth_relus() if smooth else contextlib.nullcontext():
            ref = pe_step(hp, batch, "cpu", f64=True)
            with swapped(torch.backends.cudnn, allow_tf32=True):
                res[f"card_{tag}"] = read(pe_step(hp, batch, device), ref)
            res[f"cpu_{tag}"] = read(pe_step(hp, batch, "cpu"), ref)
            if smooth:
                # the planted fault: pe's convolutions at the default TF32
                with swapped(fnn, true_f32_convs=contextlib.nullcontext), \
                        swapped(torch.backends.cudnn, allow_tf32=True):
                    res["fault_smooth"] = read(pe_step(hp, batch, device),
                                               ref)
    rel = max(res["card_relu"]["loss"], res["card_smooth"]["loss"],
              res["card_smooth"]["grad"])
    fault = res["fault_smooth"]["grad"]
    timing = time_steps(PitchExtractionTask(hp, device=device), batch,
                        reps=5)
    res.update(rel_l2=rel, tol=PE_STEP_TOL, fault_rel_l2=fault,
               timing=timing)

    def show(r):
        return (f"loss {r['loss']:.3e}, largest grad {r['grad']:.3e} "
                f"{[(n, f'{e:.2e}') for n, e in r['worst']]}")

    for key in ("card_relu", "cpu_relu", "card_smooth", "cpu_smooth"):
        log(f"[train2] pe step vs f64 on the CPU, {key}: {show(res[key])}")
    log(f"[train2] pe step gate: the card's loss and its smooth twin's loss "
        f"and grads {rel:.3e} (tol {PE_STEP_TOL:g}); the ReLU model's grads"
        f" not gated (branch flips, the CPU's alike); planted fault "
        f"[convolutions at cuDNN's default TF32: {fault:.3e}]")
    log_steps("train2", "pe task step", batch, timing)
    if not rel <= PE_STEP_TOL:
        raise SmokeError(f"the pe step disagrees with f64: {res}")
    if not fault > PE_STEP_TOL:
        raise SmokeError(f"the planted pe fault passes: {res}")
    return res


def phase_pe(device, workdir, launches):
    """(b) The pe task at config_24k's pe width: 16 clips binarized at 24
    kHz, run_task with the pe task_cls, one step against f64 on the CPU,
    and the step's checkpoint as a config_24k Svc's pe_ckpt converting
    the 14 s clip with use_pe (K2 and K3 moving)."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch import infer_cli
    from diffsvc_tpu_torch.config import set_hparams
    from diffsvc_tpu_torch.data.binarizer import binarize
    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.models.hubert import HubertConfig
    from diffsvc_tpu_torch.run import run_task
    from diffsvc_tpu_torch.training import checkpoint as ckpt_lib
    from diffsvc_tpu_torch.training.pe_task import PitchExtractionTask
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import load_wav, save_wav

    cfg_fn = write_pe_data(workdir)
    hp = set_hparams(config=cfg_fn, exp_name="smoke_pe", reset=True,
                     print_hparams=False)
    t0 = time.time()
    binarize(hp, device=device)
    res = {"binarize_s": time.time() - t0}
    hp = set_hparams(config=cfg_fn, exp_name="smoke_pe", reset=True,
                     print_hparams=False)
    t0 = time.time()
    # pe has no kernel of its own: its training launches none of K1-K6
    with counted("pe run_task", launches, moved=(), still=ALL_KERNELS,
                 tag="train2"):
        trainer = run_task(hp)
    res["fit_s"] = time.time() - t0
    losses = [h["loss"] for h in trainer.history]
    res["losses"] = losses
    log(f"[train2] pe task (config_24k, hidden {hp['hidden_size']}, "
        f"{trainer.task.conv_layers} conv layers, {hp['audio_num_mel_bins']} "
        f"mel): binarized {PE_CLIPS} clips in {res['binarize_s']:.2f}s; "
        f"{trainer.global_step} steps in {res['fit_s']:.2f}s, losses "
        f"{[round(x, 5) for x in losses]}")
    if not isinstance(trainer.task, PitchExtractionTask) \
            or len(losses) != hp["max_updates"] \
            or not np.isfinite(losses).all():
        raise SmokeError(f"pe training: {res}")
    res["vs_f64"] = pe_step_vs_f64(hp, device, step_batch(hp))
    ckpt = ckpt_lib.latest_checkpoint(hp["work_dir"])
    trained = {k: v.detach().cpu()
               for k, v in trainer.task.model.state_dict().items()}
    del trainer
    torch.cuda.empty_cache()
    # the trained pe as a config_24k Svc's pe_ckpt
    t0 = time.time()
    proj_cfg, proj_ckpt = synth.write_project(
        os.path.join(workdir, "proj24pe"),
        {"base_config": [os.path.join(ROOT, "configs", "config_24k.yaml")],
         "pe_ckpt": ckpt}, VOC24_H, hubert_cfg=HubertConfig())
    svc = Svc("proj24pe", proj_cfg, True, proj_ckpt, device=device)
    if svc.pe is None or not all(torch.equal(v.cpu(), trained[k]) for k, v
                                 in svc.pe.state_dict().items()):
        raise SmokeError("Svc did not load the trained pe as pe_ckpt")
    secs, f0, gaps = CLIPS[SERVE_CLIP]
    wav_fn = os.path.join(workdir, "clip24pe.wav")
    save_wav(synth.voiced_wav(secs, PE_SR, f0, gaps, seed=2), wav_fn, PE_SR)
    with counted("24k modular float32, the trained pe", launches,
                 tag="train2"):
        _, _, audio = infer_cli.run_clip(
            svc, key=0, acc=ACC, use_pe=True, use_crepe=False, thre=0.05,
            use_gt_mel=False, add_noise_step=500, file_path=wav_fn,
            out_path=wav_fn[:-4] + "_out.wav")
    res["svc_peak"] = clip_checks("24k with the trained pe", audio,
                                  len(load_wav(wav_fn)[0]))
    res["svc_s"] = time.time() - t0
    log(f"[train2] the trained pe loaded as pe_ckpt (svc.pe set, weights "
        f"equal) and converted the {secs:.0f}s clip with use_pe")
    return res


def phase_infer(device, workdir, cfg_fn, launches):
    """(c) ``--infer`` on phase 5's step-6 checkpoint: a [P] wav, png
    (where matplotlib is installed) and npy per test item, each wav finite
    and non-silent, each mel inside [mel_vmin, mel_vmax]; K2 once per item,
    K3 once per wav."""
    import glob

    import numpy as np
    import torch

    from diffsvc_tpu_torch.config import HParams, set_hparams
    from diffsvc_tpu_torch.run import run_task
    from diffsvc_tpu_torch.utils.audio_io import load_wav

    hp = HParams(dict(set_hparams(config=cfg_fn, exp_name="smoke_train",
                                  reset=True, print_hparams=False),
                      infer=True, gen_dir_name="smoke"))
    n_items = len(np.load(os.path.join(hp["binary_data_dir"],
                                       "test_lengths.npy")))
    label = "--infer, phase 5's step-6 checkpoint"
    t0 = time.time()
    with counted(label, launches, tag="train2", still=(
            "residual_stack_train_batched", "residual_stack_train",
            "fused_residual_block")):
        run_task(hp)
    wall = time.time() - t0
    counts = launches[label]
    gen = os.path.join(hp["work_dir"], f"generated_{TRAIN_STEPS}_smoke")
    wavs = sorted(glob.glob(os.path.join(gen, "wavs", "[[]P[]]*.wav")))
    pngs = glob.glob(os.path.join(gen, "plot", "[[]P[]]*.png"))
    mels = glob.glob(os.path.join(hp["work_dir"], "P_mels_npy", "*.npy"))
    res = {"items": n_items, "wavs": len(wavs), "pngs": len(pngs),
           "npys": len(mels), "s": wall, "s_per_item": wall / max(n_items, 1),
           "launches": counts}
    for fn in mels:
        mel = np.load(fn)
        if mel.min() < hp["mel_vmin"] or mel.max() > hp["mel_vmax"]:
            raise SmokeError(f"--infer mel {fn} outside [mel_vmin, mel_vmax]")
    for fn in wavs:
        wav, _ = load_wav(fn)
        if not np.isfinite(wav).all() or np.abs(wav).max() < 1e-3:
            raise SmokeError(f"--infer wav {fn} not finite or silent")
    # the plots need matplotlib; without it the runner prints "plot failed"
    # per item and writes the rest, as JAX's does
    try:
        import matplotlib  # noqa: F401

        want_pngs = n_items
    except ImportError:
        want_pngs = 0
    res["matplotlib"] = bool(want_pngs)
    log(f"[train2] --infer: {n_items} test items, {len(wavs)} [P] wavs, "
        f"{len(pngs)} pngs (matplotlib {'present' if want_pngs else 'absent'}"
        f" here), {len(mels)} npys in {wall:.2f}s "
        f"({res['s_per_item']:.3f} s/item); K2 launches "
        f"{counts['plms_ladder']}, K3 {counts['vocoder_tail']}")
    if not (n_items == len(wavs) == len(mels) > 0) \
            or len(pngs) != want_pngs \
            or counts["plms_ladder"] != n_items \
            or counts["vocoder_tail"] != len(wavs):
        raise SmokeError(f"--infer: {res}")
    torch.cuda.empty_cache()
    return res


def binarized_items(hp, prefix="train"):
    from diffsvc_tpu_torch.data.indexed_datasets import IndexedDataset

    ds = IndexedDataset(os.path.join(hp["binary_data_dir"], prefix))
    return [ds[i] for i in range(len(ds))]


def timed_binarize(hp, device, label: str) -> float:
    import torch

    from diffsvc_tpu_torch.data.binarizer import binarize

    torch.cuda.synchronize()
    t0 = time.time()
    binarize(hp, device=device)
    torch.cuda.synchronize()
    s = time.time() - t0
    log(f"[train2] binarize {label}: {s:.2f}s, "
        f"{TRAIN_CLIPS / s:.2f} items/s")
    return s


def phase_binarize(device, workdir, cfg_fn, launches):
    """(d) The batched binarizer on phase 5's 32 clips (AC tracker):
    batch 8 against batch 1, item by item at JAX's own test tolerances; the
    units' rel-L2 printed; the f0 cache on the per-item path, written by
    one run and hit on every item by the next."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.config import HParams, set_hparams
    from diffsvc_tpu_torch.data import features

    base = set_hparams(config=cfg_fn, exp_name="smoke_bin", reset=True,
                       print_hparams=False)

    def hp_for(tag, **kw):
        return HParams(dict(base, binary_data_dir=os.path.join(
            workdir, f"bin_{tag}"), config_path=os.path.join(
                workdir, f"bin_{tag}.yaml"), **kw))

    hps = {"batched": hp_for("b8", binarize_batch_size=8),
           "per_item": hp_for("b1", binarize_batch_size=1)}
    res = {}
    for k, hp in hps.items():
        # HuBERT-soft and the AC tracker on the card; none of K1-K6
        label = f"binarize_batch_size {hp['binarize_batch_size']}"
        with counted(label, launches, moved=(), still=ALL_KERNELS,
                     tag="train2"):
            res[k] = {"s": timed_binarize(hp, device, label)}
    for r in res.values():
        r["items_per_s"] = TRAIN_CLIPS / r["s"]
    got = binarized_items(hps["batched"])
    want = binarized_items(hps["per_item"])
    units_rel, f0_max = [], 0.0
    if [x["item_name"] for x in got] != [x["item_name"] for x in want]:
        raise SmokeError("batched and per-item binarize hold other items")
    for a, b in zip(got, want):
        try:
            np.testing.assert_allclose(a["mel"], b["mel"], rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(a["f0"], b["f0"], rtol=1e-4,
                                       atol=1e-3)
            np.testing.assert_array_equal(a["mel2ph"], b["mel2ph"])
        except AssertionError as e:
            raise SmokeError(f"batched vs per-item, {a['item_name']}: {e}")
        if a["len"] != b["len"] or a["hubert"].shape != b["hubert"].shape:
            raise SmokeError(f"{a['item_name']}: len or units shape differ")
        units_rel.append(rel_l2(torch.from_numpy(a["hubert"]),
                                torch.from_numpy(b["hubert"])))
        f0_max = max(f0_max, float(np.abs(a["f0"] - b["f0"]).max()))
    res["compare"] = {"items": len(got), "f0_max_abs_hz": f0_max,
                      "units_rel_l2_mean": float(np.mean(units_rel)),
                      "units_rel_l2_max": float(np.max(units_rel))}
    log(f"[train2] batched vs per-item, {len(got)} train items: mel, f0 "
        f"(max |diff| {f0_max:.3e} Hz), mel2ph and len within JAX's test "
        f"tolerances; units rel_l2 mean {np.mean(units_rel):.3e} max "
        f"{np.max(units_rel):.3e} (not gated: other padding, as in JAX)")
    # the f0 cache on the per-item path: one run writes, the next hits
    cache = os.path.join(workdir, "f0cache")
    calls = {"n": 0}
    track = features.get_pitch_ac

    def counting(*a, **k):
        calls["n"] += 1
        return track(*a, **k)

    runs = []
    with swapped(features, get_pitch_ac=counting):
        for tag in ("cache1", "cache2"):
            calls["n"] = 0
            hp = hp_for(tag, binarize_batch_size=1, f0_cache_dir=cache)
            runs.append({"s": timed_binarize(hp, device, f"per item with "
                                             f"f0_cache_dir ({tag})"),
                         "tracked": calls["n"]})
    files = len(os.listdir(cache))
    res["cache"] = {"runs": runs, "files": files}
    log(f"[train2] f0 cache: the first run tracked {runs[0]['tracked']} "
        f"items and left {files} files; the second tracked "
        f"{runs[1]['tracked']} (hits on every item); "
        f"{runs[0]['s']:.2f}s then {runs[1]['s']:.2f}s")
    if files != TRAIN_CLIPS or runs[0]["tracked"] != TRAIN_CLIPS \
            or runs[1]["tracked"] != 0:
        raise SmokeError(f"the f0 cache: {res['cache']}")
    return res


def phase_train2(device, workdir):
    """Phase 9 on phase 5's data and checkpoint: RAdam, the pe task,
    --infer and the batched binarizer with the f0 cache."""
    cfg_fn = os.path.join(workdir, "train.yaml")
    launches = {}
    res = {"radam": phase_radam(device, workdir, cfg_fn, launches),
           "pe": phase_pe(device, workdir, launches),
           "infer": phase_infer(device, workdir, cfg_fn, launches),
           "binarize": phase_binarize(device, workdir, cfg_fn, launches)}
    res["launches"] = launches
    return res


def deterministic_step(bundle_fn: str) -> int:
    """Phase 5's child: one step twice from the bundle's state, batch, t and
    noise under ``torch.use_deterministic_algorithms``; prints whether the
    params came out identical and K4's launches (its parent sets
    ``CUBLAS_WORKSPACE_CONFIG``, which that mode needs for cuBLAS)."""
    import torch

    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4
    from diffsvc_tpu_torch.training.task import SVCTask
    from diffsvc_tpu_torch.utils.convert import torch_load

    b = torch_load(bundle_fn)
    task = SVCTask(HParams(b["hp"]), device="cuda")
    params = []
    torch.use_deterministic_algorithms(True)
    for _ in range(2):
        task.load_state_dict(b["snap"])
        task.train_step(b["batch"], t=b["t"], noise=b["noise"])
        params.append([p.detach().clone() for p in task.params])
    print(json.dumps({"identical": all(torch.equal(x, y)
                                       for x, y in zip(*params)),
                      "launches": k4.launches}))
    return 0


# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="write the full record (JSON)")
    ap.add_argument("--deterministic-step", default="", metavar="BUNDLE",
                    help="phase 5's child process: run one step twice from "
                    "BUNDLE under deterministic algorithms")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "diffsvc_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(diffsvc_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.deterministic_step:
        return deterministic_step(args.deterministic_step)
    record = {}
    try:
        card = card_line()
        log(f"[card] {card}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
        device = torch.device("cuda", 0)

        from diffsvc_tpu_torch.ops.hopper import _build

        t0 = time.time()
        _build.lib()
        record["build_s"] = time.time() - t0
        record["build_log"] = _build.build_log
        log(f"[build] kernels ready in {record['build_s']:.2f}s "
            f"(nvcc {_build.build_seconds})")
        for line in _build.build_log.splitlines():
            if "registers" in line or "spill" in line or "(C75" in line:
                log(f"[ptxas] {line.strip()}")

        record["kernels"] = phase_kernels(device)
        from diffsvc_tpu_torch.ops.hopper import diffnet_block as k6

        # K6 is on no path: phases 4-9 must not launch it
        k6.launches = k6.launches_tc = k6.launches_tf32x3 = 0
        with tempfile.TemporaryDirectory() as tmp:
            cwd = os.getcwd()
            os.chdir(tmp)     # Svc keeps its ./infer_tools caches here
            try:
                record["slice"], project = phase_slice(device, tmp)
                record["train"] = phase_train(device, tmp)
                cfg = train_config(tmp)
                record["own_batch"] = phase_train_own_batch(
                    device, tmp, cfg["hubert_path"], cfg["vocoder_ckpt"])
                record["serve"] = phase_serve(device, project)
                record["rest"] = phase_rest(device, project, tmp)
                record["train2"] = phase_train2(device, tmp)
            finally:
                os.chdir(cwd)
        torch.cuda.synchronize()
        record["k6_path_launches"] = k6.launches
        log(f"[paths] K6 launches over phases 4-9: {k6.launches}")
        if k6.launches != 0:
            raise SmokeError(f"K6 was launched {k6.launches} times on a path; "
                             "no path of the port runs it")
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    entries = []
    # each kernel's launches on the path that runs it: K1-K3 the conversions
    # (phase 4), K4 the trainer at max_sentences 24 (phase 5), K5 the trainer
    # at the config's own batch (phase 6); K6 is on no path, so its count over
    # phases 4-9, which must be 0; launches_rest: phase 8's routes (DDPM,
    # the 24 kHz profile); launches_train2: phase 9's parts (RAdam's
    # run_task, the trained pe's conversion, --infer)
    launches = dict(record["slice"]["launches"],
                    residual_stack_train_batched=record["train"]["launches"],
                    residual_stack_train=record["own_batch"]["launches"][
                        "residual_stack_train"],
                    fused_residual_block=record["k6_path_launches"])
    tc_launches = record["slice"]["launches_tc"]
    for name, (src, replaces) in KERNELS.items():
        by_dt = record["kernels"][name]
        main_dt = "bf16" if "bf16" in by_dt else "f32"
        main = by_dt[main_dt]
        measured = ("max_abs_err", "rel_l2", "ms", "plain_ms", "bound_ms",
                    "bound_by")
        entries.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": main["max_abs_err"],
                        "ms": main["ms"], "plain_ms": main["plain_ms"],
                        "bound_ms": main["bound_ms"],
                        "bound_by": main["bound_by"], "library_ms": None,
                        "dtype": main_dt,
                        "launches_tc": tc_launches["bfloat16"][
                            "launches_tc"].get(name),
                        "launches_tf32x3": tc_launches["float32"][
                            "launches_tf32x3"].get(name),
                        "main_path": name != "fused_residual_block",
                        "launches_serving": {
                            route: counts[name] for route, counts in
                            record["serve"]["launches"].items()},
                        "launches_rest": {
                            route: counts[name] for route, counts in
                            record["rest"]["launches"].items()},
                        "launches_train2": {
                            part: counts[name] for part, counts in
                            record["train2"]["launches"].items()},
                        "by_dtype": {dt: {k: r[k] for k in measured}
                                     for dt, r in by_dt.items()}})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, **record}, f, indent=1,
                      default=lambda o: o.item())   # numpy scalars
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
