"""``forward_ms.train``: a training step's forward pass
(``Trainer.train_step``'s ``model.calculate_loss``: K2, the tables'
cat and stack, BPR, EmbLoss), as the program's span
``fit/epoch/step/forward`` times it on the host: median ms, over the
spans the profiler did not slow."""

from portbench import program_spans


def read(rec):
    return program_spans.median_ms("fit/epoch/step/forward")
