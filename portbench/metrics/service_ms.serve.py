"""``service_ms.serve``: the time of one call into the server
(``serve.RecServer.recommend`` / ``serve.SessionServer.recommend``),
without its wait in the queue, host clock, median over the calls the
profiler did not slow."""

from portbench.harness import quantile


def read(rec):
    return quantile(rec.spans.get("recommend", []), 0.5) * 1e3 \
        if rec.spans.get("recommend") else None
