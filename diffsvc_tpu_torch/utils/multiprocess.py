"""Ordered multiprocess map (reference utils/multiprocess_utils.py:6-47).

A copy of ``diffsvc_tpu/utils/multiprocess.py``; ``tests/test_torch_standalone.py``
holds it against the original.

Used for CPU-bound per-item work (artifact saving, host-side feature
fallbacks). Stages that run on the card must NOT run under this (a CUDA
context does not survive a fork); they batch on the device instead.
"""

from __future__ import annotations

import multiprocessing
import traceback
from typing import Callable, List


def _worker(fn, in_q, out_q):
    while True:
        item = in_q.get()
        if item is None:
            break
        idx, args = item
        try:
            out_q.put((idx, fn(*args)))
        except Exception:
            traceback.print_exc()
            out_q.put((idx, None))


def chunked_multiprocess_run(fn: Callable, args_list: List, num_workers=None,
                             ordered: bool = True):
    """Yield fn(*args) results (ordered by input index by default)."""
    num_workers = num_workers or multiprocessing.cpu_count()
    num_workers = min(num_workers, len(args_list)) or 1
    # fork: cheap and works from any entry point; only safe BEFORE any
    # device/runtime initialization (host-side preprocessing stages)
    ctx = multiprocessing.get_context("fork")
    in_q: multiprocessing.Queue = ctx.Queue()
    out_q: multiprocessing.Queue = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(fn, in_q, out_q), daemon=True)
             for _ in range(num_workers)]
    for p in procs:
        p.start()
    for i, args in enumerate(args_list):
        in_q.put((i, args))
    for _ in procs:
        in_q.put(None)

    results = {}
    next_idx = 0
    for _ in range(len(args_list)):
        idx, res = out_q.get()
        if not ordered:
            yield idx, res
            continue
        results[idx] = res
        while next_idx in results:
            yield next_idx, results.pop(next_idx)
            next_idx += 1
    for p in procs:
        p.join()
