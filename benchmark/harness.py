"""What every cell's run shares: finding a cell's files by name, the cache
directories, spans, the traced window, the device's busy union, the
per-layer readers, the comparison's report and the result line.

A cell is ``benchmark/workloads/<cell>.json``; it names its configuration
(``benchmark/configs/<config>.json``), its traffic mix
(``benchmark/traffic/<mix>.json``, read by the generator the mix names in
``benchmark/generators/``) and the entry that drives the program
(``benchmark/entries/<entry>.py``).  Per-layer metrics are the readers
``benchmark/metrics/<metric>.py`` that ``BENCHMARK.json`` lists for the
cell.  Nothing here names a cell, a configuration or a metric.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# top-level module names the process may not hold once the window closes:
# the JAX stack and the JAX package (compared whole: the port's name starts
# with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "diffsvc_tpu")


def set_cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernel build is ``build/diffsvc_tpu_torch/<hash>/``),
    and no library's JAX backend."""
    cache = ROOT / "build" / "benchmark_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(kind: str, name: str, root: Path = BENCH) -> dict:
    path = root / kind / f"{name}.json"
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = BENCH):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    mod_name = "benchmark_" + kind + "_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def bench_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str) -> tuple:
    """(end-to-end names, per-layer names) this cell reports."""
    e2e = [m["name"] for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    layer = [m["name"] for m in spec["per_layer"]
             if cell in m.get("workloads", [cell]) and m["moves"] in e2e]
    return e2e, layer


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """One run of one cell: its files, arguments, spans and readings.

    An entry fills ``setup_s``, ``e2e``, ``work``, ``attempted``,
    ``failed``, ``checks`` and ``counters``, and brackets its measured
    window with :meth:`window`."""

    def __init__(self, cell: str, workload: dict, config: dict,
                 traffic: dict, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float, root: Path = BENCH):
        self.cell, self.workload, self.config = cell, workload, config
        self.traffic, self.seed, self.seconds = traffic, int(seed), \
            float(seconds)
        self.trace, self.device, self.t_start = bool(trace), device, t_start
        self.root = root
        self.spans = []          # (label, t0, t1, info) on the host clock
        self.work = []           # the units of work the window completed
        self.counters = {}
        self.checks = []         # (name, value, limit)
        self.e2e = {}
        self.attempted = self.failed = 0
        self.setup_s = None
        self.t0 = self.t1 = None
        self.memory_peak = 0
        self.device_events = []  # (start s, end s, name) inside the window
        self.host_events = []    # (start s, end s, label) inside the window
        self._prof = None

    # -------------------------------------------------------------- spans
    @contextlib.contextmanager
    def span(self, label: str, **info):
        """A host span (and, in a traced run, a profiler range of the same
        name, on the trace's clock)."""
        rf = None
        if self._prof is not None:
            import torch

            rf = torch.profiler.record_function("bench/" + label)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield info
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.spans.append((label, t0, t1, info))

    def window_spans(self, label: str) -> list:
        """(t0, t1, info) of the spans ``label`` inside the window."""
        return [(t0, t1, info) for lab, t0, t1, info in self.spans
                if lab == label and t0 >= self.t0 and t1 <= self.t1]

    def sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    @contextlib.contextmanager
    def window(self):
        """The measured window: set-up ends where it starts; with tracing
        the profiler records the card (and the spans) inside it; on exit
        the card is drained and its memory peak read."""
        import torch

        self.sync()
        self.setup_s = time.perf_counter() - self.t_start
        prof = None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
            self._prof = prof
        self.t0 = time.perf_counter()
        try:
            with self.span("window"):
                yield self
                self.sync()
        finally:
            self.t1 = time.perf_counter()
            self._prof = None
            if prof is not None:
                prof.__exit__(None, None, None)
                self._read_trace(prof)
            if self.device == "cuda":
                self.memory_peak = int(torch.cuda.max_memory_allocated())

    def _read_trace(self, prof) -> None:
        from torch.autograd import DeviceType

        dev, host, win = [], [], None
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if getattr(e, "is_hidden_event", lambda: False)():
                continue
            if name.startswith("bench/"):
                # the spans' ranges: on the host, and mirrored on the
                # card's timeline as annotations, which are no device work
                if e.device_type() == DeviceType.CUDA:
                    continue
                host.append((e.start_ns() / 1e9, e.end_ns() / 1e9, name[6:]))
                if name == "bench/window":
                    win = host[-1]
            elif e.device_type() == DeviceType.CUDA:
                dev.append((e.start_ns() / 1e9, e.end_ns() / 1e9, name))
        if win is None:
            raise RuntimeError("the trace lost the window's range")
        a, b = win[0], win[1]
        self.trace_window = (a, b)
        self.device_events = [(max(s, a), min(t, b), n) for s, t, n in dev
                              if t > a and s < b]
        self.host_events = [h for h in host if h[2] != "window"]

    # ------------------------------------------------------------ readings
    def busy(self):
        """(busy seconds, idle gaps [(start, end)]) of the union of the
        card's intervals in the traced window."""
        a, b = self.trace_window
        busy, reach, gaps = 0.0, a, []
        for s, t, _ in sorted(self.device_events):
            if s > reach:
                gaps.append((reach, s))
            busy += max(0.0, t - max(s, reach))
            reach = max(reach, t)
        if b > reach:
            gaps.append((reach, b))
        return busy, gaps

    def kernel_seconds(self, pattern) -> dict:
        """{kernel name: device seconds} of the traced kernels whose name
        ``pattern`` (a compiled regex) finds."""
        out = {}
        for s, t, n in self.device_events:
            if pattern.search(n):
                out[n] = out.get(n, 0.0) + (t - s)
        return out

    def breakdown(self) -> dict:
        """The 10 device operations that took most time, and the idle time
        by what the host was doing (the innermost benchmark span around
        each gap's middle)."""
        ops = {}
        for s, t, n in self.device_events:
            key = n.replace("(anonymous namespace)::", "").split("(")[0][:80]
            ops[key] = ops.get(key, 0.0) + (t - s)
        _, gaps = self.busy()
        idle = {}
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            label = "outside spans"
            best = None
            for s, t, lab in self.host_events:
                if s <= mid <= t and (best is None or t - s < best):
                    best, label = t - s, lab
            idle[label] = idle.get(label, 0.0) + (g1 - g0)
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        gap_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gap_top]}


def device_info(run: Run) -> dict:
    if run.device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(run.workload.get("chips", 1)),
            "memory_peak_bytes": run.memory_peak}


def judge(run: Run) -> tuple:
    """(correct, {name: {"value", "limit"}}) of the run's comparison: every
    unit of work done, none failed, and every number within its limit."""
    checks = {}
    correct = run.failed == 0 and run.attempted > 0 and bool(run.checks)
    for name, value, limit in run.checks:
        ok = value is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    return bool(correct), checks


def report(run: Run, spec: dict) -> dict:
    """The result line of a finished run (and the comparison's lines on
    standard error, last)."""
    e2e_names, layer_names = cell_metrics(spec, run.cell)
    units = {m["name"]: m["unit"] for m in spec["end_to_end"]
             + spec["per_layer"]}
    metrics = {}
    if run.trace:
        for name in layer_names:
            reader = load_module("metrics", name, run.root)
            value = reader.read(run)
            if value is not None:
                if not math.isfinite(value):
                    raise RuntimeError(f"{name} read {value}")
                metrics[name] = {"value": float(value), "unit": units[name]}
    else:
        vals = dict(run.e2e, setup_s=run.setup_s)
        for name in e2e_names:
            if name not in vals:
                raise RuntimeError(f"the entry did not measure {name}")
            metrics[name] = {"value": float(vals[name]), "unit": units[name]}
    correct, checks = judge(run)
    out = {"correct": correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics,
           "device": device_info(run)}
    if run.trace:
        busy, _ = run.busy()
        if run.device == "cuda" and not busy > 0:
            raise RuntimeError("the traced window holds no device operation")
        out["device"]["busy_s"] = busy
        out["device"]["window_s"] = run.trace_window[1] - run.trace_window[0]
        out["breakdown"] = run.breakdown()
    out["checks"] = checks
    return out


def emit(result: dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)
