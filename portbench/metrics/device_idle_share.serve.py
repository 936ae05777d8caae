"""The share of the traced sub-window in which no operation ran on the
device: one minus the union of the device's kernel, copy and fill
intervals over the sub-window's length, in %."""

from portbench.harness import idle_share


def read(rec):
    return idle_share(rec.trace)
