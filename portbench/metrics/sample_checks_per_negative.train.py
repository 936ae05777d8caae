"""``sample_checks_per_negative.train``: the negative sampler's
membership tests (``data/sampler``: the pairs tested against the used
set, over every redraw round; counter ``checked``) per negative it
returned (counter ``drawn``), both counted under the program's span
``fit/epoch/sample`` outside the profiler.  1 where only the redrawn
pairs are tested again."""

from portbench import program_spans


def read(rec):
    return program_spans.counter_ratio("fit/epoch/sample", "checked",
                                       "drawn")
