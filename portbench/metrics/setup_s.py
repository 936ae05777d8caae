"""``setup_s``: seconds from the start of the process to the start of
the window (loading, building, warming up, and on a first run in a
checkout the kernels' builds)."""


def read(rec):
    return rec.setup_s
