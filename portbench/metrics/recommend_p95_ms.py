"""``recommend_p95_ms``: the 95th percentile of the latency over all
requests of the window, each from when it was due."""

from portbench.harness import quantile


def read(rec):
    return quantile(rec.latency_ms, 0.95)
