"""``nce_roofline.train``'s reader on hand-counted traces and shapes."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench.reference import sgl

SHAPES = {"n_users": 300, "n_items": 700, "n_nodes": 1000, "n_edges": 5000,
          "d": 64, "n_layers": 3, "batch": 128}


def _rec(ops):
    return harness.Record(trace={"ops": ops, "busy_s": 1e-4,
                                 "window_s": 1e-3},
                          shapes=dict(SHAPES), reference=sgl)


def _read():
    return harness.load_module("metrics", "nce_roofline.train").read


def test_reads_none_without_the_kernels():
    read = _read()
    # the parent's step: the InfoNCE as ATen's GEMMs and softmax
    ops = [("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8", 0.0,
            50.0),
           ("void at::native::(anonymous namespace)::cunn_SoftMaxForward",
            50.0, 60.0),
           ("void ell_row_kernel<float, 4>(float const*)", 60.0, 70.0)]
    assert read(_rec(ops)) is None
    assert read(_rec([])) is None
    assert read(harness.Record(trace=None, shapes=dict(SHAPES))) is None
    # the kernels' other passes without a forward: no call to count
    assert read(_rec([("(anonymous namespace)::nce_grad_kernel(float "
                       "const*)", 0.0, 5.0)])) is None


def test_reads_the_hand_counted_share():
    read = _read()
    # the profiler's names of the D = 64 instances
    fwd = ("void (anonymous namespace)::nce_lse_kernel<64>(float const*, "
           "float const*, int, int, int, float, int, float*, float*, float*)")
    comb = "(anonymous namespace)::nce_combine_kernel(float const*)"
    grad = "void (anonymous namespace)::nce_grad_kernel<64>(float const*)"
    fin = "(anonymous namespace)::nce_finish_kernel(float const*, int)"
    # one step: two calls, each forward 10 µs + combine 1 µs, backward
    # 12 µs + finish 1 µs; 24 µs a call, 48 µs the step; an unrelated
    # kernel in between counts for nothing
    ops = []
    for t0 in (0.0, 100.0):
        ops += [(fwd, t0, t0 + 10.0), (comb, t0 + 10.0, t0 + 11.0),
                ("elementwise_kernel", t0 + 11.0, t0 + 40.0),
                (grad, t0 + 40.0, t0 + 52.0), (fin, t0 + 52.0, t0 + 53.0)]
    b, d, n = 128, 64, 1000
    flops = 6 * b * n * d                 # 49,152,000
    n_bytes = 4 * (6 * b * d + 3 * n * d + 6 * b)
    least_us = max(flops / 67e12, n_bytes / 3.35e12) * 1e6
    assert least_us == pytest.approx(flops / 67e12 * 1e6)   # operations
    assert read(_rec(ops)) == pytest.approx(least_us / 48.0 * 100)
    # the same as the reference's InfoNCE term of a step
    assert flops == sgl.flops_per_step(SHAPES) - sgl.flops_per_step(
        dict(SHAPES, n_users=0, n_items=0))
    # two steps: twice the work in twice the time
    twice = ops + [(name, a + 200.0, b_ + 200.0) for name, a, b_ in ops]
    assert read(_rec(twice)) == pytest.approx(read(_rec(ops)))
