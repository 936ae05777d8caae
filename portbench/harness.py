"""The pieces every runner and reader shares: finding a cell's files by
name, host spans, the profiler's traced sub-window and what is read
from it, the device's description and the check for JAX in the process.

Nothing here names a cell, a configuration or a metric: those are
files under ``portbench/`` that the harness finds by the names in
``BENCHMARK.json``.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "flax", "recbole_gnn_tpu")
SPAN_PREFIX = "pb."


def load_json(kind: str, name: str, base: str = PKG) -> dict:
    with open(os.path.join(base, kind, f"{name}.json"), encoding="utf-8") as f:
        return json.load(f)


def load_module(kind: str, name: str, base: str = PKG):
    """``<base>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(base, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of loaded modules that are JAX, its libraries or
    the JAX package (the part before the first dot, compared whole)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def tree(flat: dict) -> dict:
    """``{"a.b": x}`` → ``{"a": {"b": x}}``."""
    out: dict = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def flat(nested: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in nested.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


class Spans:
    """Host-clock spans around the calls into the program's layers, by
    name.  While the profiler runs each is also a profiler range named
    ``pb.<name>``, and its duration goes to ``traced``, apart from the
    others: the per-layer readers take the spans the profiler did not
    slow."""

    def __init__(self):
        self.durations: dict[str, list[float]] = defaultdict(list)
        self.traced: dict[str, list[float]] = defaultdict(list)
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        traced = self.annotate
        rf = (torch.profiler.record_function(SPAN_PREFIX + name)
              if traced else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with rf:
                yield
        finally:
            (self.traced if traced else self.durations)[name].append(
                time.perf_counter() - t0)


class Tracer:
    """``torch.profiler`` over a sub-window of the measured window:
    :meth:`poll` starts it ``after_s`` into the window and stops it
    ``span_s`` later; :meth:`summary` reads the device's operations.
    ``held_s`` is the whole time the profiler held the window, its
    start and stop included, which the per-layer readers leave out."""

    def __init__(self, spans: Spans, after_s: float, span_s: float,
                 device: torch.device):
        self.spans, self.after_s, self.span_s = spans, after_s, span_s
        self.device = device
        self.prof = None
        self._rf = None
        self.t0 = self.t_start = None
        self.held_s = 0.0
        self.log: dict[str, float] = {}
        self.done = False

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def _activities(self) -> list:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def prepare(self) -> None:
        """A short profiler session at the end of set-up: the profiler's
        first start in a process initialises the device's tracing
        (seconds on the card), which would otherwise fall in the
        window."""
        t = time.perf_counter()
        with torch.profiler.profile(activities=self._activities()):
            torch.ones(1, device=self.device).add_(1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.log["prepare_took_s"] = time.perf_counter() - t

    def begin(self, t0: float) -> None:
        self.t0 = t0

    def poll(self) -> None:
        if self.done or self.t0 is None:
            return
        now = time.perf_counter()
        if self.prof is None and now - self.t0 >= self.after_s:
            self._held = now
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.prof = torch.profiler.profile(activities=self._activities())
            self.prof.start()
            self.spans.annotate = True
            self._rf = torch.profiler.record_function(SPAN_PREFIX + "window")
            self._rf.__enter__()
            self.t_start = time.perf_counter()
            self.log["start_at_s"] = now - self.t0
            self.log["start_took_s"] = self.t_start - now
        elif self.prof is not None and now - self.t_start >= self.span_s:
            self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._rf.__exit__(None, None, None)
        t = time.perf_counter()
        self.spans.annotate = False
        self.prof.stop()
        self.done = True
        self.held_s = time.perf_counter() - self._held
        self.log["stop_took_s"] = time.perf_counter() - t
        self.log["held_s"] = self.held_s

    def summary(self) -> dict | None:
        """Device intervals, busy and window seconds, the top device
        operations and the idle time by the host span it fell in."""
        if not self.done:
            return None
        t_read = time.perf_counter()
        dev_ops, spans, window = [], [], None
        for e in self.prof.events():
            tr = e.time_range
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # the profiler mirrors host ranges onto the device's
                # timeline; only the device's own operations count
                if not e.name.startswith(SPAN_PREFIX):
                    dev_ops.append((e.name, tr.start, tr.end))
            elif e.name == SPAN_PREFIX + "window":
                window = (tr.start, tr.end)
            elif e.name.startswith(SPAN_PREFIX):
                spans.append((e.name[len(SPAN_PREFIX):], tr.start, tr.end))
        if window is None:
            return None
        w0, w1 = window
        ops = [(n, max(a, w0), min(b, w1)) for n, a, b in dev_ops
               if b > w0 and a < w1]
        by_name: dict[str, float] = defaultdict(float)
        for n, a, b in ops:
            by_name[n] += (b - a) * 1e-6
        merged = []
        for _, a, b in sorted(ops, key=lambda o: o[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged) * 1e-6
        gaps, last = [], w0
        for a, b in merged + [[w1, w1]]:
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        idle: dict[str, float] = defaultdict(float)
        spans.sort(key=lambda s: s[1])
        starts = [s[1] for s in spans]
        for g0, g1 in gaps:
            label = "other"
            # the innermost span holding the gap's start: of the few
            # latest to start at or before it, the first whose end is
            # after it (the benchmark's spans nest at most two deep)
            i = bisect.bisect_right(starts, g0) - 1
            for j in range(i, max(i - 4, -1), -1):
                if spans[j][2] > g0:
                    label = spans[j][0]
                    break
            idle[label] += (g1 - g0) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        self.log["read_took_s"] = time.perf_counter() - t_read
        self.log["device_ops"] = len(ops)
        return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy,
                "ops": ops, "device_ops": [[n, s] for n, s in top],
                "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                    key=lambda kv: -kv[1])[:10]}


def device_description(device: torch.device, count: int,
                       peak: int | None) -> dict:
    """The result's ``device``: ``peak`` is the window's peak, read
    before the reference ran."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": None}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "memory_peak_bytes": peak}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc.__class__.__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "not read"


def idle_share(trace: dict | None) -> float | None:
    """The traced sub-window's share in which the device ran nothing,
    in %; None without a trace or with no device operation in it."""
    if trace is None or not trace["window_s"] or not trace["ops"]:
        return None
    return (1.0 - trace["busy_s"] / trace["window_s"]) * 100.0


def quantile(values, q: float) -> float | None:
    return float(np.quantile(np.asarray(values, float), q)) if len(values) \
        else None


def finite(value: float, cap: float = 1e300) -> float:
    """A JSON-safe number: non-finite readings (a served item the
    reference masks, a NaN loss) become ``cap``, which fails any
    limit."""
    value = float(value)
    return value if np.isfinite(value) else cap


class Record:
    """What a runner hands back: the window's observations, for the
    metric readers, and the numbers compared, for ``correct``."""

    def __init__(self, **kw):
        self.setup_s = self.window_s = None
        self.attempted = self.failed = 0
        self.work: dict = {}
        self.latency_ms: list = []
        self.spans: dict = {}
        self.trace = None
        self.shapes: dict = {}
        self.checks: dict = {}
        self.cfg: dict = {}
        self.device = None
        self.memory_peak_bytes = None
        self.base = PKG
        self.reference = None
        self.__dict__.update(kw)


def memory_peak(device: torch.device) -> int | None:
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))
