"""``sample_ms.train``: the negative sampler (``data/sampler``:
``UniformNegativeSampler.sample``, the epoch's draw at its first
batch), as the program's span ``fit/epoch/sample`` times it on the
host: its total over the count of training steps (``fit/epoch/step``),
in ms a step, over the spans the profiler did not slow.  A part of
``loader_wait_ms.train``, on the same base."""

from portbench import program_spans


def read(rec):
    return program_spans.per_step_ms("fit/epoch/sample")
