"""``recommend_p50_ms``: the median latency over all requests of the
window, each from when it was due to when its answer was on the
host."""

from portbench.harness import quantile


def read(rec):
    return quantile(rec.latency_ms, 0.50)
