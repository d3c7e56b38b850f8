"""Does one training step repeat bit for bit, and what makes it repeat?

At the train-stream A/B's shape (``tools/ab_train_stream.py``: B=24 x
T=1024, C=384, L=20) and for each of its three legs (K4 at the bf16 stream,
K5, K4 at the f32 stream), the A/B's first ``--warm`` steps are taken (the
zero-initialized output head zeroes every gradient inside the denoiser at
step 0, so a check there sees nothing of the stack's backward), then the
next step is taken ``--repeats`` times from that one state, on one batch
and one set of draws.  Each take records the loss, the gradient of every
parameter and of the conditioner's output (``decoder_inp``), the
gradients at the training stack's boundary (the cotangent of its skip sum
coming in, and of its seven operands going out: ``k:dskip``,
``k:dx`` ...), and every parameter after the optimizer's update.  The
takes are compared tensor by tensor inside a process, and by fingerprint
(an exact integer checksum of each tensor's bytes) across two processes,
in four modes, each in processes of its own:

  * ``default``: as the port runs;
  * ``flag``: ``torch.use_deterministic_algorithms(True, warn_only=True)``
    (ATen's deterministic kernels, uninitialized memory filled with NaN;
    cuBLAS as by default);
  * ``env``: ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment;
  * ``both``: the two together (the deterministic children of
    ``chip_smoke.py``).

The first tensor that differs, in the order of the step's backward, names
the op; the mode that mends it says whether the port's code or a library's
default algorithm is the source.  Prints one JSON line on stdout (every
log goes to stderr) and writes it to ``<out>/step_repeat.json``.

    python -m diffsvc_tpu_torch.tools.step_repeat [--modes default,flag,...]
        [--warm 3] [--repeats 4] [--out DIR] [--tiny] [--device cpu]

It runs on the card and raises without one; ``--device cpu`` asks for the
CPU.  ``--tiny`` selects the A/B's tiny widths, not the device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

from .train_demo import REPO, device_info, log

MODES = {"default": {}, "flag": {},
         "env": {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"},
         "both": {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}}
FLAG_MODES = ("flag", "both")
STACK_OPERANDS = ("x", "sb", "cond_proj", "wd", "bd", "wo", "bo")


def backward_order(names) -> list:
    """The record's keys in the order the step's backward produces them:
    the loss; the denoiser's output end (its output and skip projections);
    the cotangent into the training stack and the stack's operand grads;
    the residual layers' parameters from the last; the step MLP and the
    input projection; the conditioner's output; the embeddings; the
    parameters after the update."""
    def rank(n):
        if n == "loss":
            return (0, 0)
        if n.startswith("param:"):
            return (9, 0)
        if n == "k:dskip":
            return (1, 2)
        if n.startswith("k:"):
            return (1, 3)
        if n == "grad:cond":
            return (5, 0)
        if ".output_projection" in n and "residual_layers" not in n:
            return (1, 0)
        if ".skip_projection" in n:
            return (1, 1)
        if ".residual_layers." in n:
            return (2, -int(n.split(".residual_layers.")[1].split(".")[0]))
        if ".denoise_fn." in n:
            return (3, 0)
        return (6, 0)
    return sorted(names, key=rank)


@contextlib.contextmanager
def stack_hooks(captured: dict):
    """K4's and K5's wrappers, as ``diffnet.apply`` calls them, with hooks
    that keep the gradient of the stack's skip sum (``k:dskip``) and of
    each operand (``k:dx`` ...) in ``captured``."""
    from ..ops.hopper import diffnet_stack_per_sample as k5
    from ..ops.hopper import diffnet_stack_train as k4

    def keep(name):
        return lambda g: captured.__setitem__(f"k:{name}", g.detach().clone())

    def hooked(fn):
        def call(*ops, **kw):
            for name, op in zip(STACK_OPERANDS, ops):
                if op.requires_grad:
                    op.register_hook(keep(f"d{name}"))
            out = fn(*ops, **kw)
            if out.requires_grad:
                out.register_hook(keep("dskip"))
            return out
        return call

    saved = (k4.residual_stack_train_batched, k5.residual_stack_train)
    k4.residual_stack_train_batched = hooked(saved[0])
    k5.residual_stack_train = hooked(saved[1])
    try:
        yield
    finally:
        k4.residual_stack_train_batched, k5.residual_stack_train = saved


def step_record(task, batch: dict, t, noise) -> dict:
    """One step from the task's current state: the loss, every parameter's
    gradient and the conditioner's (``grad:cond``), the stack's boundary
    gradients, then the parameters after ``train_step`` on the same batch
    and draws (the optimizer and the clipping too).  Tensors stay on the
    task's device."""
    import torch

    captured = {}
    with stack_hooks(captured):
        loss, ret = task.model.training_loss(task.prepare_batch(batch), t=t,
                                             noise=noise)
        cond = ret["decoder_inp"]
        grads = torch.autograd.grad(loss, [*task.params, cond],
                                    allow_unused=True)
    rec = {"loss": loss.detach().reshape(1), **captured}
    for name, g in zip([*task.names, "cond"], grads):
        if g is not None:
            rec[f"grad:{name}"] = g.detach().clone()
    task.train_step(batch, t=t, noise=noise)
    for name, p in zip(task.names, task.params):
        rec[f"param:{name}"] = p.detach().clone()
    return rec


def differ(a: dict, b: dict) -> list:
    """The keys whose tensors are not equal bit for bit, in the step's
    backward order, each with its largest absolute difference."""
    import torch

    out = []
    for k in backward_order(a):
        if not torch.equal(a[k], b[k]):
            out.append([k, float((a[k].double() - b[k].double()).abs().max())])
    return out


def fingerprint(t) -> list:
    """An exact checksum of a tensor's bytes: the sum of its 16-bit words
    and of each word times its position's weight, in int64 (integer sums do
    not depend on their order)."""
    import torch

    words = t.detach().contiguous().view(-1).view(torch.int16)
    total, weighted, chunk = 0, 0, 1 << 26
    for i in range(0, words.numel(), chunk):
        w = words[i:i + chunk].to(torch.int64)
        pos = torch.arange(i, i + w.numel(), device=w.device) % 65521 + 1
        total += int(w.sum())
        weighted += int((w * pos).sum())
    return [total, weighted]


def child(mode: str, out_fn: str, tiny: bool, device_name: str, warm: int,
          repeats: int) -> dict:
    """One process of ``mode``: per leg, ``warm`` A/B steps, then the next
    step ``repeats`` times from one state; writes the first take's
    fingerprints to ``out_fn`` and returns the in-process comparisons and
    each take's seconds."""
    import torch

    from ..config import HParams
    from ..infer.svc import default_device
    from ..training.task import SVCTask
    from . import ab_train_stream as ts

    if mode in FLAG_MODES:
        torch.use_deterministic_algorithms(True, warn_only=True)
    device = default_device(device_name)
    d = ts.dims(ts.parse_args(["--tiny"] if tiny else []))
    batches = [ts.make_batch(d, i) for i in range(ts.N_BATCHES)]
    res, prints = {}, {}
    for leg, extra in ts.LEGS:
        task = SVCTask(HParams(dict(ts.base_hp(d), **extra)), device=device)
        for s in range(warm):
            t, noise = ts.step_draws(s, d, task.model.K_step, device)
            task.train_step(batches[s % ts.N_BATCHES], t=t, noise=noise)
        snap = task.state_dict()
        snap["global_step"] = task.step
        t, noise = ts.step_draws(warm, d, task.model.K_step, device)
        batch = batches[warm % ts.N_BATCHES]
        first, diffs, secs = None, [], []
        for _ in range(repeats):
            task.load_state_dict(snap)
            t0 = time.time()
            rec = step_record(task, batch, t, noise)
            secs.append(time.time() - t0)
            if first is None:
                first = rec
            else:
                diffs.append(differ(first, rec))
            del rec
        prints[leg] = {k: fingerprint(v) for k, v in first.items()}
        prints[leg].update({f"snap:{k}": fingerprint(v) for k, v in
                            snap["state_dict"].items()})
        res[leg] = {"route": ts.leg_route(task.hp, d), "in_process": diffs,
                    "step_s": secs}
        del task, first
        if device.type == "cuda":
            torch.cuda.empty_cache()
    with open(out_fn, "w") as f:
        json.dump(prints, f)
    return res


def run(args) -> dict:
    """Two child processes per mode; returns, per mode and leg, the keys
    that differ inside each process and between the two."""
    from ..infer.svc import default_device

    device = default_device(args.device)
    info = device_info(device)
    log(f"| device: {info['device']} ({info['card']})")
    result = {**info, "warm": args.warm, "repeats": args.repeats,
              "modes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in args.modes:
            prints, per = [], []
            for rep in range(2):
                fn = os.path.join(tmp, f"{mode}{rep}.json")
                env = {k: v for k, v in os.environ.items()
                       if k != "CUBLAS_WORKSPACE_CONFIG"}
                env.update(PYTHONPATH=REPO, **MODES[mode])
                cmd = [sys.executable, "-m", "diffsvc_tpu_torch.tools."
                       "step_repeat", "--child", mode, fn, "--device",
                       args.device, "--warm", str(args.warm), "--repeats",
                       str(args.repeats)] + (["--tiny"] if args.tiny else [])
                proc = subprocess.run(cmd, env=env, capture_output=True,
                                      text=True, timeout=900, cwd=REPO)
                if proc.returncode != 0:
                    raise RuntimeError(f"step_repeat child {mode}: exit "
                                       f"{proc.returncode}\n"
                                       f"{proc.stderr[-3000:]}")
                per.append(json.loads(proc.stdout.strip().splitlines()[-1]))
                with open(fn) as f:
                    prints.append(json.load(f))
            result["modes"][mode] = {
                leg: {"route": per[0][leg]["route"],
                      "in_process": [p[leg]["in_process"] for p in per],
                      "across_processes": [
                          k for k in backward_order(prints[0][leg])
                          if prints[0][leg][k] != prints[1][leg][k]],
                      "step_s": [p[leg]["step_s"] for p in per]}
                for leg in per[0]}
            for leg, r in result["modes"][mode].items():
                takes = [x for p in r["in_process"] for x in p]
                log(f"| {mode} {leg} ({r['route']}): in process "
                    f"{sum(bool(x) for x in takes)} of {len(takes)} takes "
                    f"differ, first keys {[x[:2] for x in takes if x][:2]}; "
                    f"across processes {len(r['across_processes'])} keys "
                    f"differ {r['across_processes'][:4]}")
    result["repeats_bit_for_bit"] = {
        mode: all(not r["across_processes"] and not any(
            x for p in r["in_process"] for x in p) for r in legs.values())
        for mode, legs in result["modes"].items()}
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default=",".join(MODES),
                    help=f"comma-separated, of {', '.join(MODES)}")
    ap.add_argument("--warm", type=int, default=3,
                    help="A/B steps before the repeated one")
    ap.add_argument("--repeats", type=int, default=4,
                    help="takes of the step in each process")
    ap.add_argument("--out", default=None,
                    help="default runs/torch_step_repeat (--tiny: "
                    "runs/torch_step_repeat_tiny)")
    ap.add_argument("--tiny", action="store_true",
                    help="the A/B's tiny widths (B=2, T=256, C=128, L=4)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--child", nargs=2, default=None,
                    metavar=("MODE", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.modes = [m for m in args.modes.split(",") if m]
    unknown = sorted(set(args.modes) - set(MODES))
    if unknown:
        ap.error(f"unknown modes {unknown}")
    if args.out is None:
        args.out = os.path.join(REPO, "runs", "torch_step_repeat"
                                + ("_tiny" if args.tiny else ""))
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.child:
        with contextlib.redirect_stdout(sys.stderr):
            res = child(*args.child, args.tiny, args.device, args.warm,
                        args.repeats)
        print(json.dumps(res))
        return res
    with contextlib.redirect_stdout(sys.stderr):
        result = run(args)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "step_repeat.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
