"""The benchmark's one command:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the checkout's root.  One process: set-up, warm-up, the measured
window, the check of what the window produced against the plain
reference, one JSON line last on standard output (logs on standard
error).  It measures the port, ``diffsvc_tpu_torch``, on the card and
exits non-zero without printing a result when there is no card (or fewer
than the cell asks for), when the program is not beside it, or when the
JAX stack or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

T_START = time.perf_counter()


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root=None, overrides=None) -> dict:
    """Run one cell and return its result line (as a dict).  ``root`` is
    the benchmark folder to read the cell's files from; ``overrides``
    replaces any of 'workload', 'config', 'traffic' (tests run tiny
    widths on the CPU through this)."""
    from . import harness

    root = harness.BENCH if root is None else root
    overrides = overrides or {}
    workload = overrides.get("workload") or harness.load_json(
        "workloads", cell, root)
    config = overrides.get("config") or harness.load_json(
        "configs", workload["config"], root)
    traffic = overrides.get("traffic") or harness.load_json(
        "traffic", workload["traffic"], root)
    run = harness.Run(cell, workload, config, traffic, seed, seconds, trace,
                      device, overrides.get("t_start", T_START), root)
    entry = harness.load_module("entries", workload["entry"], root)
    entry.run(run)
    return harness.report(run, harness.bench_spec(root.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import harness

    harness.set_cache_env()
    workload = harness.load_json("workloads", args.workload)
    import torch

    need = int(workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        harness.log(f"no result: the cell needs {need} CUDA device(s), "
                    f"this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    # the program's prints (and its processes') go to standard error: the
    # result is the one line on standard output
    sys.stdout.flush()
    out_fd = os.dup(1)
    os.dup2(2, 1)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    finally:
        sys.stdout.flush()
        os.dup2(out_fd, 1)
        os.close(out_fd)
    bad = harness.forbidden_loaded()
    if bad:
        harness.log(f"no result: the process loaded {bad}")
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
