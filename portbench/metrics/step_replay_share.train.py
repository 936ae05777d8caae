"""``step_replay_share.train``: the share of the window's training steps
that replayed the step's CUDA graph (``Trainer.train_step``'s counter
``replayed``) among all of them (counter ``steps``), both counted under
the program's span ``fit/epoch/step`` outside the profiler, in %.  None
where the program keeps no such counters."""

from portbench import program_spans


def read(rec):
    share = program_spans.counter_ratio("fit/epoch/step", "replayed",
                                        "steps")
    return None if share is None else share * 100.0
