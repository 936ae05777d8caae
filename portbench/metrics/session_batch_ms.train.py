"""``session_batch_ms.train``: the session loader's host time a step
(``data/loader.SequentialTrainLoader``: the epoch's permutation, span
``fit/epoch/shuffle``, and each batch's slices of the session and
session-graph arrays with their padding, span ``fit/epoch/batch``),
the two spans' total over the count of training steps
(``fit/epoch/step``), in ms a step, over the spans the profiler did not
slow.  None where the program keeps no such spans."""

from portbench import program_spans


def read(rec):
    parts = [program_spans.per_step_ms(p)
             for p in ("fit/epoch/batch", "fit/epoch/shuffle")]
    return None if None in parts else sum(parts)
