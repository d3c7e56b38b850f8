"""The program's spans and counters: what the host was doing, on the clock
a device trace is read against.

``span(name, **attrs)`` is a context manager that records the span's
name, start, end, parent (the innermost span open on the same thread),
thread and request: a span opened with no parent starts a request (one
``run_clip`` call, one ``train_step``) and its descendants inherit its
id.  ``count(name, n)`` adds to a named counter.  Times are
``time.perf_counter()``.

Tracing is on while a ``torch.profiler`` session records (any thread of
the process: the profiler's own per-thread flag, or the flag its Python
front end sets for the whole process) or after :func:`enable`.  On,
records go to a bounded buffer (:func:`spans`, :func:`counters`,
:func:`dropped`, :func:`reset`), and each span opens a profiler range
``svc/<name>``, so a profiler's export shows the spans on the device
timeline's own clock.  The range is a function-scope record
(``_RecordFunctionFast``), not ``record_function``'s user annotation: the
profiler mirrors a user annotation onto the card's timeline as a device
event over the kernels launched inside it, which a reader of the trace
would take for the card being busy.  Off, :func:`span` is one check that
returns a shared context that does nothing, and :func:`count` returns.

:func:`idle_split` gives a device trace's idle intervals to the innermost
span open at each moment; ``infer_cli --trace PATH`` writes the buffer as
Chrome-trace JSON (:func:`write_chrome`).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 100_000      # spans, and counter increments, the buffer keeps

_profiler_enabled = torch._C._autograd._profiler_enabled
_profiler_range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    id: int
    name: str
    t0: float
    t1: float
    parent: Optional[int]
    thread: int
    request: int
    attrs: dict


class Count(NamedTuple):
    name: str
    t: float
    n: int


class _Open:
    """One span being recorded."""

    __slots__ = ("tracer", "name", "attrs", "id", "parent", "request", "t0",
                 "range")

    def __init__(self, tracer, name, attrs):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self):
        stack = self.tracer._stack()
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, next(self.tracer._requests)
        self.id = next(self.tracer._ids)
        stack.append(self)
        self.range = _profiler_range("svc/" + self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self.range.__exit__(None, None, None)
        tracer = self.tracer
        tracer._stack().pop()
        tracer._keep(tracer._spans, Span(
            self.id, self.name, self.t0, t1, self.parent,
            threading.get_ident(), self.request, self.attrs))
        return False


class Tracer:
    """A buffer of spans and counter increments (the module's functions
    use one for the process)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.enabled = False
        self._local = threading.local()
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._requests = itertools.count()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._spans, self._counts = [], []
            self.dropped = 0

    def on(self) -> bool:
        return self.enabled or _autograd_profiler._is_profiler_enabled \
            or _profiler_enabled()

    def span(self, name: str, **attrs):
        if not self.on():
            return _OFF
        return _Open(self, name, attrs)

    def count(self, name: str, n: int = 1) -> None:
        if not self.on():
            return
        self._keep(self._counts, Count(name, time.perf_counter(), n))

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _keep(self, buf: list, rec) -> None:
        with self._lock:
            if len(buf) < self.capacity:
                buf.append(rec)
            else:
                self.dropped += 1

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def counters(self, since: Optional[float] = None,
                 until: Optional[float] = None) -> dict:
        """Each counter's sum of the increments the buffer holds; with
        ``since`` / ``until``, of those recorded inside [since, until]."""
        with self._lock:
            counts = list(self._counts)
        lo = -float("inf") if since is None else since
        hi = float("inf") if until is None else until
        out = {}
        for c in counts:
            if lo <= c.t <= hi:
                out[c.name] = out.get(c.name, 0) + c.n
        return out

    def chrome(self) -> dict:
        """The buffer as a Chrome trace: a complete event per span (its
        attributes, id, parent and request under ``args``), a counter
        event per increment with the running total, and the totals and
        the dropped count under ``otherData``."""
        pid = os.getpid()
        with self._lock:
            spans, counts = list(self._spans), list(self._counts)
            dropped = self.dropped
        events = [{"name": s.name, "ph": "X", "ts": s.t0 * 1e6,
                   "dur": (s.t1 - s.t0) * 1e6, "pid": pid, "tid": s.thread,
                   "args": dict(s.attrs, id=s.id, parent=s.parent,
                                request=s.request)} for s in spans]
        running = {}
        for c in counts:
            running[c.name] = running.get(c.name, 0) + c.n
            events.append({"name": c.name, "ph": "C", "ts": c.t * 1e6,
                           "pid": pid, "args": {c.name: running[c.name]}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"counters": running, "dropped": dropped}}


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
spans = TRACER.spans
counters = TRACER.counters
reset = TRACER.reset
on = TRACER.on


def enable() -> None:
    TRACER.enabled = True


def disable() -> None:
    TRACER.enabled = False


def dropped() -> int:
    return TRACER.dropped


def write_chrome(path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(TRACER.chrome(), f, default=str)


def _innermost(spans) -> list:
    """Disjoint (start, end, name) pieces of properly nested (start, end,
    name) spans sorted by start, longest first: each piece named by the
    innermost span open over it."""
    out, stack, cur = [], [], None
    for s0, s1, name in spans:
        while stack and stack[-1][1] <= s0:
            _, e1, n = stack.pop()
            out.append((cur, e1, n))
            cur = e1
        if stack:
            out.append((cur, s0, stack[-1][2]))
        stack.append((s0, s1, name))
        cur = s0
    while stack:
        _, e1, n = stack.pop()
        out.append((cur, e1, n))
        cur = e1
    return [p for p in out if p[1] > p[0]]


def idle_split(records, gaps, offset: float = 0.0) -> dict:
    """Seconds of ``gaps`` (sorted, disjoint (start, end) intervals, such as
    a device trace's idle ones) by the innermost of ``records`` (one
    thread's spans, moved onto the gaps' clock by ``offset``) open at each
    moment; the time no span covers is under None."""
    pieces = _innermost(sorted(((r.t0 + offset, r.t1 + offset, r.name)
                                for r in records),
                               key=lambda s: (s[0], -s[1])))
    out, i = {}, 0
    for g0, g1 in gaps:
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        covered, j = 0.0, i
        while j < len(pieces) and pieces[j][0] < g1:
            p0, p1, name = pieces[j]
            d = min(p1, g1) - max(p0, g0)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
                covered += d
            j += 1
        if g1 - g0 > covered:
            out[None] = out.get(None, 0.0) + (g1 - g0 - covered)
    return out


def idle_share(records, gaps, offset: float, window, root: str,
               prefix: str) -> Optional[float]:
    """Percent of ``window`` ((start, end) on the gaps' clock) in which
    ``gaps`` fall under spans named ``prefix``..., by :func:`idle_split` of
    the records on the thread of the first ``root`` span among them; None
    where ``records`` hold no ``root`` span."""
    roots = [r for r in records if r.name == root]
    if not roots:
        return None
    split = idle_split([r for r in records if r.thread == roots[0].thread],
                       gaps, offset)
    return 100.0 * sum(v for k, v in split.items()
                       if k and k.startswith(prefix)) / (window[1] - window[0])
