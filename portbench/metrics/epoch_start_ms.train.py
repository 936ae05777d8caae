"""``epoch_start_ms.train``: the model's per-epoch hook
(``model.epoch_start``: SGL's two views, drawn, re-normalised and
regathered into their ELL slot weights), as the program's span
``fit/epoch_start`` times it on the host, the device waits inside it
included: its total over the count of training steps
(``fit/epoch/step``), in ms a step, over the spans the profiler did not
slow.  None where the program keeps no such span."""

from portbench import program_spans


def read(rec):
    return program_spans.per_step_ms("fit/epoch_start")
