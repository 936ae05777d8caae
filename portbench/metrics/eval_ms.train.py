"""``eval_ms.train``: the time of one validation that ``fit`` runs
(``eval/evaluator.Evaluator.evaluate``: propagation, full sort,
history mask, top-k, metrics), host clock, mean per validation, over
the validations the profiler did not slow."""


def read(rec):
    spans = rec.spans.get("evaluate")
    return sum(spans) / len(spans) * 1e3 if spans else None
