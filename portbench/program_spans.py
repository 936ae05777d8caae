"""The program's own spans and counters (``recbole_gnn_tpu_torch``'s
``utils/trace.py``) as the ``program_span`` and ``program_counter``
readers take them: the spans the profiler did not slow, by path (a
training window's under ``fit/``).  Each function returns None where the
program keeps no such store or no such path, as a program older than
the store does."""

from __future__ import annotations

import numpy as np


def unprofiled() -> dict:
    """``{path: agg}`` of the spans opened outside a profiler; ``{}``
    where the program has no span store."""
    try:
        from recbole_gnn_tpu_torch.utils import trace
    except ImportError:
        return {}
    return trace.snapshot()["unprofiled"]


def median_ms(path: str) -> float | None:
    """The median duration of the spans at ``path``, in ms."""
    agg = unprofiled().get(path)
    if not agg or not agg["durations_ns"]:
        return None
    return float(np.median(agg["durations_ns"])) * 1e-6


def per_step_ms(path: str, step: str = "fit/epoch/step") -> float | None:
    """The spans at ``path`` in all, over the count of the spans at
    ``step``, in ms a step."""
    spans = unprofiled()
    agg, steps = spans.get(path), spans.get(step)
    if not agg or not steps or not steps["count"]:
        return None
    return agg["total_ns"] / steps["count"] * 1e-6


def counter_ratio(path: str, num: str, den: str) -> float | None:
    """Counter ``num`` over counter ``den``, both kept at ``path``."""
    agg = unprofiled().get(path)
    if not agg or not agg["counters"].get(den):
        return None
    return agg["counters"].get(num, 0) / agg["counters"][den]
