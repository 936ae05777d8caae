"""``loader_wait_ms.train``: the training loop's wait for its next
batch (``data/loader`` and ``data/sampler``: shuffling, negative
sampling, slicing the session arrays), host clock, mean per step,
over the steps the profiler did not slow."""


def read(rec):
    waits = rec.spans.get("loader")
    steps = rec.work.get("steps", 0) - rec.work.get("steps_traced", 0)
    if not waits or steps <= 0:
        return None
    return sum(waits) / steps * 1e3
