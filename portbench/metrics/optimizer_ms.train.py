"""``optimizer_ms.train``: a training step's optimizer update
(``train/optim``: Adam, in place), as the program's span
``fit/epoch/step/optimizer`` times it on the host: median ms, over the
spans the profiler did not slow."""

from portbench import program_spans


def read(rec):
    return program_spans.median_ms("fit/epoch/step/optimizer")
