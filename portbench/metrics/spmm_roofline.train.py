"""``spmm_roofline.train``: the propagation SpMMs' share of their
roofline inside the traced sub-window, in %: the sum of the calls'
least times (each the larger of x read once, out written once and 8
bytes per real edge over HBM's bandwidth, or 2·E·d operations over
the float32 peak: ``frozen/roofline.py``) over the sum of the profiled
device times of every kernel the configuration's SpMM implementation
launches (``kernels/<impl>.json``; one ``per_call`` kernel each call).
Whatever layout or kernel does the work is held to the same count."""

import re

from portbench import harness
from portbench.frozen.roofline import bound_ms, spmm_bytes


def read(rec):
    t = rec.trace
    if t is None or not t["ops"] or not rec.shapes:
        return None
    impl = rec.cfg["port"].get("sparse_spmm_impl", "ell")
    try:
        names = harness.load_json("kernels", impl, rec.base)["spmm"]
    except FileNotFoundError:
        return None

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
    n_out, n_in, e = rec.reference.spmm_calls(rec.shapes)
    least_ms = bound_ms(*spmm_bytes(n_out, n_in, e, rec.shapes["d"]))
    return calls * least_ms * 1e3 / device_us * 100.0
