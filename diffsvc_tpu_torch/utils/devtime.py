"""Device time, analytic FLOP counts and bounds on the card.

The one home of the timers, peaks, bounds and FLOP counts that
``chip_smoke.py`` and the port's measurement tools (``tools/
mfu_decompose.py``, ``train_decompose.py``, ``bench_pipe_stages.py``,
``bench_realtime.py``, ``soak_serving.py``) share.  Nothing here imports
torch at module level, so ``chip_smoke.py`` imports it on a machine without
one.

Two FLOP conventions for a training step of the residual stack, per row
(one frame of one sample) and layer, in units of C^2:

* **model FLOPs** (:func:`train_model_flops`): 3x the forward's 16, i.e. 48,
  the convention of the JAX tool ``tools/train_decompose.py:127`` (the
  backward counted as twice the forward);
* **hardware FLOPs** (:func:`train_hardware_flops`): the forward's 16 plus
  the backward as the kernels run it, 44 (the recomputed gate 12, dh 4,
  dy 12, dWo 4, dW 12; ``tools/train_decompose.py:245``), i.e. 60.

A share of the peak that exceeds 1 is a timing fault (a window that ended
before the work did); :func:`share` raises :class:`TimingFault` on it.
"""

from __future__ import annotations

import time

# Published dense peaks of one H100 SXM (NVIDIA's data sheet): FLOP/s by
# operand type (f32 outside the tensor cores) and device-memory bytes/s.
# "tf32x3": f32 products as three TF32 passes on the tensor cores (495
# TFLOP/s dense TF32 over 3), the rate K1's and K2's f32 kernels run at.
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32x3": 495e12 / 3}
PEAK_BYTES = 3.35e12

# c^2 FLOPs per row and layer of the residual stack
FWD_PER_ROW = 16          # gate 12 + output 4
BWD_PER_ROW = 44          # recomputed gate 12, dh 4, dy 12, dWo 4, dW 12
MODEL_PER_ROW = 3 * FWD_PER_ROW               # 48: the model-FLOP count
HARDWARE_PER_ROW = FWD_PER_ROW + BWD_PER_ROW  # 60: the hardware count


class TimingFault(RuntimeError):
    """A measured time shorter than the card's peak allows."""


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timers
# ---------------------------------------------------------------------------

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


def host_time_ms(fn, reps: int) -> float:
    """Mean host wall time of ``fn`` over ``reps`` back-to-back runs (one
    warm-up run first): the CPU's counterpart of :func:`cuda_time_ms`."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def time_ms(fn, reps: int, device) -> float:
    """:func:`cuda_time_ms` on the card, :func:`host_time_ms` elsewhere."""
    if getattr(device, "type", str(device)) == "cuda":
        return cuda_time_ms(fn, reps)
    return host_time_ms(fn, reps)


def best_ms(fn, reps: int, rounds: int, device) -> float:
    """The least of ``rounds`` readings of :func:`time_ms`."""
    return min(time_ms(fn, reps, device) for _ in range(max(rounds, 1)))


def wall_ms(fn, reps: int, device) -> float:
    """Host wall per call of ``fn`` over ``reps`` calls, the card drained
    before the clock starts and after the last call (one warm-up first)."""
    import torch

    def sync():
        if getattr(device, "type", str(device)) == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps


def time_in_turns(kern, plain, reps: int):
    """(kernel ms, plain ms), each the mean of two measurements taken in
    the order plain, kernel, kernel, plain, so drift on the card (clocks,
    power) falls on both sides alike."""
    p1 = cuda_time_ms(plain, reps)
    k1 = cuda_time_ms(kern, reps)
    k2 = cuda_time_ms(kern, reps)
    p2 = cuda_time_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def launches() -> dict:
    """The kernels' launch counters: K1's stacks, K2's ladders, K3's tails,
    K4's forward and backward calls (``K4``) and its backward calls alone
    (``K4_bwd``), K5's per-sample backward calls, K6's layers."""
    from ..ops.hopper import (diffnet_block, diffnet_stack,
                              diffnet_stack_per_sample, diffnet_stack_train,
                              plms_ladder, vocoder_tail)

    return {"K1": diffnet_stack.launches, "K2": plms_ladder.launches,
            "K3": vocoder_tail.launches, "K4": diffnet_stack_train.launches,
            "K4_bwd": diffnet_stack_train.bwd_launches,
            "K5": diffnet_stack_per_sample.launches,
            "K6": diffnet_block.launches}


def launched(before: dict) -> dict:
    """The launches since ``before`` (a reading of :func:`launches`)."""
    return {k: v - before[k] for k, v in launches().items()}


# ---------------------------------------------------------------------------
# bounds and shares
# ---------------------------------------------------------------------------

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
    res = bound(flops, moved, tc_rate(dtype_name))
    if dtype_name == "f32":
        res["cuda_core_bound_ms"] = bound(flops, moved, "f32")["bound_ms"]
    return res


def tc_rate(dtype_name: str) -> str:
    """The peak a kernel of this operand dtype runs at: the bf16 tensor
    cores, or at f32 the tensor cores' 3xTF32 split products."""
    return "tf32x3" if dtype_name == "f32" else "bf16"


def share(flops: float, ms: float, rate: str) -> float:
    """``flops`` done in ``ms`` as a share of ``PEAK_FLOPS[rate]``; raises
    :class:`TimingFault` when it exceeds 1 (or the time is not positive)."""
    if not ms > 0:
        raise TimingFault(f"a time of {ms} ms")
    got = flops / (ms * 1e-3) / PEAK_FLOPS[rate]
    if got > 1.0:
        raise TimingFault(f"{flops:.4g} FLOP in {ms:.4g} ms is "
                          f"{100 * got:.1f}% of the {rate} peak: the timing "
                          "window ended before the work did")
    return got


# ---------------------------------------------------------------------------
# analytic FLOP counts of the denoiser (T rows, C channels, L layers, M mel
# bins, H conditioner width)
# ---------------------------------------------------------------------------

def stack_flops(rows: int, layers: int, per_row: int, c: int = 384) -> float:
    """``per_row`` c^2 FLOPs per row and layer: 16 for a forward layer
    (gate 12 + output 4), 60 for forward and backward (the backward's
    recomputed gate 12, dh 4, dy 12, dWo 4, dW_j 12)."""
    return float(per_row) * rows * c * c * layers


def eval_flops(t: int, c: int, layers: int, m: int) -> float:
    """One denoiser evaluation's matmul FLOPs, 2T(MC + 8LC^2 + C^2 + CM):
    input projection, the stack, skip and output projections
    (``tools/mfu_decompose.py:149``)."""
    return 2.0 * t * (m * c + layers * 8 * c * c + c * c + c * m)


def cond_flops(t: int, c: int, layers: int, h: int) -> float:
    """The conditioner's projection through every layer, once per clip:
    2T L H 2C (``tools/mfu_decompose.py:150``)."""
    return 2.0 * t * layers * h * 2 * c


def stack_forward_flops(b: int, t: int, c: int, layers: int) -> float:
    """The stack's forward: per layer 4 (2 T C 2C) per sample, three
    dilated-conv taps and the output projection
    (``tools/train_decompose.py:125-126``)."""
    return float(b) * layers * 4 * (2 * t * c * 2 * c)


def train_model_flops(b: int, t: int, c: int, layers: int) -> float:
    """Model FLOPs of a training step of the stack: 3x its forward
    (``tools/train_decompose.py:127``)."""
    return 3 * stack_forward_flops(b, t, c, layers)


def backward_flops(b: int, t: int, c: int, layers: int) -> float:
    """The backward as the kernels run it, with the gate's recompute: 11
    products of 2 T C 2C per layer and sample
    (``tools/train_decompose.py:245``)."""
    return float(b) * layers * 11 * (2 * t * c * 2 * c)


def train_hardware_flops(b: int, t: int, c: int, layers: int) -> float:
    """Hardware FLOPs of a training step of the stack: the forward and the
    backward with its recompute (``stack_flops(B T, L, 60, C)``)."""
    return stack_forward_flops(b, t, c, layers) + backward_flops(b, t, c,
                                                                 layers)


# ---------------------------------------------------------------------------
# profiles
# ---------------------------------------------------------------------------

def device_events(prof) -> list:
    """The card's events of a finished ``torch.profiler`` run as (start us,
    end us, name), read from its kineto results as they are:
    ``prof.events()`` first builds a record of every host event and their
    tree, which a trace of a thousand sampler steps makes slow."""
    from torch.autograd import DeviceType

    return [(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not getattr(e, "is_hidden_event", lambda: False)()]


def kernel_breakdown(fn, reps: int) -> dict:
    """Device time per call of ``fn`` by kernel (torch.profiler over
    ``reps`` calls after a warm-up): {name: [ms per call, launches per
    call]}, the name cut at its argument list and to 60 characters."""
    import torch
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
        for start, end, name in device_events(prof):
            name = name.replace("(anonymous namespace)::", "")
            tot = out.setdefault(name.split("(")[0][:60], [0.0, 0])
            tot[0] += (end - start) / 1e3 / reps
            tot[1] += 1
        if out:
            break
        log(f"[profile] trace {attempt + 1} holds no device event")
    return {k: [ms, n / reps] for k, (ms, n) in
            sorted(out.items(), key=lambda kv: -kv[1][0])}


def profile_run(label, fn):
    """torch.profiler over one call of ``fn``.  Device busy time is the
    union of the card's kernel and copy intervals; the busy share is that
    over the profiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    spans, by_name = [], {}
    for start, end, name in device_events(prof):
        spans.append((start, end))
        tot = by_name.setdefault(name, [0.0, 0])
        tot[0] += (end - start) / 1e3
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
