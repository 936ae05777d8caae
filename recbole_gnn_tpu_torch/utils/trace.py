"""Spans and counters at the port's layer boundaries, kept in memory.

``with span("step"):`` times a block and records it under its path: the
names of the spans open on this thread, joined by ``/`` (inside ``fit``
and one epoch, ``fit/epoch/step/forward``).  ``count(name, n)`` adds to
a counter kept under the innermost open span's path.  For each path the
store keeps the count, the total and self nanoseconds (self: the
duration less the part its child spans cover) and the last
:data:`KEEP` durations, for quantiles.

The times are the host's: the device runs asynchronously and nothing
here synchronizes it, so a span measures what the host spends issuing
its work (plus whatever waits on the device inside it, such as a read
of a device value).

Spans opened while a ``torch.profiler`` session runs go to a bucket of
their own (``snapshot()["profiled"]``), apart from the others, since
the profiler slows the host; each of them also enters a profiler range
named ``PREFIX + path``, so every profiler trace holds the program's
ranges on the same clock as its kernels.  The range is a plain host
range (a ``RecordFunction`` of function scope, a ``cpu_op`` in a Chrome
trace), not a user annotation: the profiler copies user annotations
onto the device's timeline, where they would read as device work.
Outside a profiler no range is entered.  There is no switch: the
aggregates are always kept, as an operator's counters are.

A span closes when its block exits, by an exception too.  No span may
stay open across a generator's ``yield``: it would hold the paths of
whatever runs between two ``next()`` calls.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque

import torch
import torch.autograd.profiler as _profiler

# the program's profiler ranges are named PREFIX + path
PREFIX = "rgt/"
# durations kept per path for quantiles
KEEP = 65_536
# a profiler range of function scope, entered and exited as a context
_range = torch._C._profiler._RecordFunctionFast
_now = time.perf_counter_ns


class _Agg:
    __slots__ = ("count", "total_ns", "self_ns", "durations", "counters")

    def __init__(self):
        self.count = self.total_ns = self.self_ns = 0
        self.durations: deque[int] = deque(maxlen=KEEP)
        self.counters: dict[str, int] = defaultdict(int)


class Span:
    """One span: a context manager that records itself into its store
    on exit.  ``t0`` is its start (``perf_counter_ns``); ``seconds`` its
    duration, once closed."""

    __slots__ = ("_store", "name", "path", "t0", "ns", "child_ns",
                 "profiled", "_rf")

    def __init__(self, store: SpanStore, name: str):
        self._store, self.name = store, name
        self.ns = None

    @property
    def seconds(self) -> float:
        return self.ns * 1e-9

    def __enter__(self) -> Span:
        stack = self._store._stack()
        self.path = (f"{stack[-1].path}/{self.name}" if stack
                     else self.name)
        self.profiled = _profiler._is_profiler_enabled
        self._rf = None
        if self.profiled:
            self._rf = _range(PREFIX + self.path)
            self._rf.__enter__()
        self.child_ns = 0
        stack.append(self)
        self.t0 = _now()
        return self

    def __exit__(self, *exc) -> None:
        ns = self.ns = _now() - self.t0
        store = self._store
        stack = store._local.stack
        stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if stack:
            stack[-1].child_ns += ns
        with store._lock:
            agg = store._agg(self.profiled, self.path)
            agg.count += 1
            agg.total_ns += ns
            agg.self_ns += ns - self.child_ns
            agg.durations.append(ns)


class SpanStore:
    """The aggregates of every path, in two buckets, and one stack of
    open spans per thread."""

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self._aggs: dict[bool, dict[str, _Agg]] = {False: {}, True: {}}

    def _stack(self) -> list[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _agg(self, profiled: bool, path: str) -> _Agg:
        aggs = self._aggs[profiled]
        agg = aggs.get(path)
        if agg is None:
            agg = aggs[path] = _Agg()
        return agg

    def span(self, name: str) -> Span:
        return Span(self, name)

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to counter ``name`` of the innermost open span's
        path (the path ``""`` outside every span), in that span's
        bucket."""
        stack = self._stack()
        if stack:
            path, profiled = stack[-1].path, stack[-1].profiled
        else:
            path, profiled = "", _profiler._is_profiler_enabled
        with self._lock:
            self._agg(profiled, path).counters[name] += int(n)

    def snapshot(self) -> dict:
        """``{"unprofiled": {path: agg}, "profiled": {path: agg}}``, each
        agg a dict of ``count``, ``total_ns``, ``self_ns``,
        ``durations_ns`` (the last :data:`KEEP`) and ``counters``."""
        with self._lock:
            return {bucket: {
                path: {"count": a.count, "total_ns": a.total_ns,
                       "self_ns": a.self_ns,
                       "durations_ns": list(a.durations),
                       "counters": dict(a.counters)}
                for path, a in self._aggs[profiled].items()}
                for bucket, profiled in (("unprofiled", False),
                                         ("profiled", True))}

    def totals(self) -> dict[str, tuple[int, int]]:
        """``{path: (count, total_ns)}`` over both buckets."""
        out: dict[str, tuple[int, int]] = {}
        with self._lock:
            for aggs in self._aggs.values():
                for path, a in aggs.items():
                    c, t = out.get(path, (0, 0))
                    out[path] = (c + a.count, t + a.total_ns)
        return out

    def since(self, mark: dict[str, tuple[int, int]]) -> dict[str, list]:
        """``{path: [count, total_ms]}`` of the spans closed since
        ``mark = totals()``."""
        out = {}
        for path, (c, t) in self.totals().items():
            c0, t0 = mark.get(path, (0, 0))
            if c > c0:
                out[path] = [c - c0, (t - t0) * 1e-6]
        return out

    def reset(self) -> None:
        """Drop every aggregate (open spans stay open)."""
        with self._lock:
            self._aggs = {False: {}, True: {}}


STORE = SpanStore()
span = STORE.span
count = STORE.count
snapshot = STORE.snapshot
totals = STORE.totals
since = STORE.since
reset = STORE.reset
