"""``captures_per_epoch.train``: the training step's CUDA-graph
captures (``train/step_graph.py``; counter ``captures`` under the
program's span ``fit/epoch/step``) over the epochs (the count of
``fit/epoch`` spans), both outside the profiler.  1 where every epoch
brings a new state (SGL's views), near 0 where one capture serves
the window.  None where the program keeps no such counter."""

from portbench import program_spans


def read(rec):
    spans = program_spans.unprofiled()
    step, epoch = spans.get("fit/epoch/step"), spans.get("fit/epoch")
    if not step or "captures" not in step["counters"] or not epoch \
            or not epoch["count"]:
        return None
    return step["counters"]["captures"] / epoch["count"]
