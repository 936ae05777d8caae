"""``backward_ms.train``: a training step's backward pass
(``torch.autograd.grad``: K2ᵀ and the other backward ops, and the
zero-fill of unused gradients), as the program's span
``fit/epoch/step/backward`` times it on the host: median ms, over the
spans the profiler did not slow."""

from portbench import program_spans


def read(rec):
    return program_spans.median_ms("fit/epoch/step/backward")
