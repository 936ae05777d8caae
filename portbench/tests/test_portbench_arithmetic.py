"""The roofline and MFU arithmetic on hand-counted shapes."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.frozen import roofline
from portbench.reference import lightgcn, srgnn


def test_spmm_bytes_by_hand():
    # 10 rows out, 20 in, 30 edges, d 4: 20·4·4 + 10·4·4 + 8·30 bytes,
    # 2·30·4 operations
    assert roofline.spmm_bytes(10, 20, 30, 4) == (320 + 160 + 240, 240)
    # bf16 x and out halve their parts
    assert roofline.spmm_bytes(10, 20, 30, 4, 2, 2) == (160 + 80 + 240, 240)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_ms(3.35e9, 1.0) == pytest.approx(1.0)
    assert roofline.bound_ms(1.0, 67e9) == pytest.approx(1.0)
    assert roofline.bound_by(3.35e9, 1.0) == "bytes"
    assert roofline.bound_by(1.0, 67e9) == "operations"


def test_lightgcn_flops_per_step_by_hand():
    shp = {"d": 64, "n_layers": 3, "n_edges": 1000, "batch": 10}
    # 3 SpMMs forward and 3 back of 2·1000·64, and 3 × 2 dot products
    # of 2·10·64
    assert lightgcn.flops_per_step(shp) == 6 * 128000 + 3 * 2 * 1280


def test_srgnn_flops_per_step_by_hand():
    d, L, n, B = 2, 3, 5, 7
    cell = 2 * (L * d * d * 2) + 2 * (L * L * d * 2) \
        + L * (2 * d) * (3 * d) * 2 + L * d * (3 * d) * 2
    readout = L * d * d * 2 + d * d * 2 + L * d * 2 + (2 * d) * d * 2
    logits = d * n * 2
    shp = {"d": d, "L": L, "n_items": n, "batch": B, "step": 1}
    assert srgnn.flops_per_step(shp) == 3 * B * (cell + readout + logits)


def rec_with_trace(ops, window_s=1.0):
    return harness.Record(
        trace={"ops": ops, "busy_s": 0.25, "window_s": window_s},
        shapes={"n_nodes": 1000, "n_edges": 5000, "d": 64, "n_layers": 3,
                "batch": 8},
        cfg={"port": {"sparse_spmm_impl": "ell"}}, reference=lightgcn,
        device=torch.device("cuda"), window_s=2.0,
        work={"steps": 100})


def test_spmm_roofline_reader_by_hand():
    read = harness.load_module("metrics", "spmm_roofline.train").read
    # two calls, each a row pass of 8 µs and a combine pass of 2 µs
    ops = [("void ell_row_kernel<float, 4>(float const*)", 0.0, 8.0),
           ("void ell_combine_kernel<float, 4>(float const*)", 8.0, 10.0),
           ("void ell_row_kernel<float, 4>(float const*)", 20.0, 28.0),
           ("void ell_combine_kernel<float, 4>(float const*)", 28.0, 30.0),
           ("elementwise_kernel", 30.0, 90.0)]
    n_bytes = 1000 * 64 * 4 * 2 + 8 * 5000
    least_us = max(n_bytes / 3.35e12, 2 * 5000 * 64 / 67e12) * 1e6
    assert read(rec_with_trace(ops)) == pytest.approx(
        2 * least_us / 20.0 * 100)
    assert read(rec_with_trace([("elementwise_kernel", 0.0, 5.0)])) is None


def test_step_mfu_and_idle_readers_by_hand():
    mfu = harness.load_module("metrics", "step_mfu.train").read
    rec = rec_with_trace([("k", 0.0, 1.0)])
    flops = lightgcn.flops_per_step(rec.shapes) * 100
    assert mfu(rec) == pytest.approx(flops / 2.0 / 67e12 * 100)
    idle = harness.load_module("metrics", "device_idle_share.train").read
    assert idle(rec) == pytest.approx(75.0)
    rec.device = torch.device("cpu")
    assert mfu(rec) is None


def test_trace_summary_by_hand():
    class E:
        def __init__(self, name, a, b, cuda):
            self.name = name
            self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                                else torch.autograd.DeviceType.CPU)
            self.time_range = type("R", (), {"start": a, "end": b})()

    class P:
        def events(self):
            return [E("pb.window", 0.0, 100.0, False),
                    E("pb.step", 0.0, 50.0, False),
                    E("pb.loader", 50.0, 100.0, False),
                    E("k1", 10.0, 30.0, True), E("k2", 20.0, 40.0, True),
                    E("k1", 60.0, 70.0, True)]

    t = harness.Tracer(harness.Spans(), 0.0, 1.0, torch.device("cpu"))
    t.prof, t.done = P(), True
    s = t.summary()
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert dict(map(tuple, s["device_ops"])) == pytest.approx(
        {"k1": 30e-6, "k2": 20e-6})
    # idle, each gap by the span its start falls in: 0–10 and 40–60 in
    # step, 70–100 in loader
    assert dict(map(tuple, s["idle_gaps"])) == pytest.approx(
        {"step": 30e-6, "loader": 30e-6})
