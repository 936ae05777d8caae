"""``session_fill.train``: the share of the training batches' dense
(B, L) session positions that hold a click: the session loader's
counter ``positions`` (Σ ``item_seq_len`` over the real rows) over its
counter ``slots`` (every row's L positions, padding rows included),
both counted under the program's span ``fit/epoch/batch`` outside the
profiler, in %.  A loader that groups sessions by length, or packs
them, raises it.  None where the program keeps no such counters."""

from portbench import program_spans


def read(rec):
    share = program_spans.counter_ratio("fit/epoch/batch", "positions",
                                        "slots")
    return None if share is None else share * 100.0
