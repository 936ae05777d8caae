"""``nce_roofline.train``: the all-node InfoNCE's share of its roofline
inside the traced sub-window, in %: the least time of the traced calls'
work (``frozen/roofline.py::bound_ms``) over the sum of the profiled
device times of every kernel the InfoNCE runs (``kernels/nce.json``).

A training step makes two calls, the batch's users against every user
row of view 2 and its items against every item row (SGL), so the steps
are the ``per_call`` (forward) kernel's launches over 2.  A step's work
is that of ``reference/sgl.py::flops_per_step``'s InfoNCE term: the
logits over every node, 2·B·n·d operations forward and twice that
back, n = users + items; its bytes each input read once and each
output written once (forward: q, k in, lse out; backward: q, k, g, lse
in, dq, dk out; f32).  Whatever kernel does the work is held to this
count.  None where the trace holds none of those kernels."""

import re

from portbench import harness
from portbench.frozen.roofline import bound_ms


def step_work(shp: dict) -> tuple[float, float]:
    """(bytes, operations) of one step's two InfoNCE calls."""
    b, d = shp["batch"], shp["d"]
    n = shp["n_users"] + shp["n_items"]
    return 4 * (6 * b * d + 3 * n * d + 6 * b), 6 * b * n * d


def read(rec):
    t = rec.trace
    if t is None or not t["ops"] or not rec.shapes:
        return None
    names = harness.load_json("kernels", "nce", rec.base)["nce"]

    def match(kernel, op):
        return re.search(rf"\b{re.escape(kernel)}\b", op) is not None

    calls, device_us = 0, 0.0
    for name, a, b in t["ops"]:
        if match(names["per_call"], name):
            calls += 1
        if any(match(k, name) for k in names["kernels"]):
            device_us += b - a
    if not calls or device_us <= 0:
        return None
    least_ms = bound_ms(*step_work(rec.shapes))
    return calls / 2 * least_ms * 1e3 / device_us * 100.0
