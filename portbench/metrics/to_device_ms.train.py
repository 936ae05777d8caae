"""``to_device_ms.train``: a batch's copy from the host to the device
(``Trainer._place``), as the program's span ``fit/epoch/to_device``
times it on the host: median ms, over the spans the profiler did not
slow."""

from portbench import program_spans


def read(rec):
    return program_spans.median_ms("fit/epoch/to_device")
