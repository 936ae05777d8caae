"""``eval_h2d_mb.train``: the megabytes the evaluator copies from the
host to the device a validation (``eval/evaluator``: counter
``h2d_bytes``, the batches it copies and a full sort's one-time
placement of its loader's arrays, over counter ``passes``, one a
validation), both counted under the program's span ``fit/evaluate``
outside the profiler.  None where the program keeps no such
counters."""

from portbench import program_spans


def read(rec):
    per_pass = program_spans.counter_ratio("fit/evaluate", "h2d_bytes",
                                           "passes")
    return None if per_pass is None else per_pass / 1e6
