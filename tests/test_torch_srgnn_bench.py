"""SR-GNN on the Diginetica shape, the benchmark's ``srgnn-diginetica``
configuration, at a tiny size on the CPU.

* The port's SR-GNN (its loss, every gradient leaf, one Adam step)
  against the float64 plain reference ``portbench/reference/srgnn.py``
  on the benchmark's seeded weights.
* ``SequentialTrainLoader``'s spans ``shuffle`` and ``batch`` and the
  counters ``rows``, ``padded_rows``, ``positions`` and ``slots``
  against sums over the batches it yields, which stay those of the
  loader without spans, array for array.
* The readers of ``session_batch_ms.train`` and ``session_fill.train``
  on a hand-made span store, None where the program kept nothing they
  read, and a tiny traced run of ``srgnn-diginetica.train`` in which
  both read a number.
"""

import importlib.util
import json
import math
import os
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench import run as bench_run
from portbench.runners import common, train
from recbole_gnn_tpu_torch.data.loader import (SequentialTrainLoader,
                                               _pad_batch, _session_batch)
from recbole_gnn_tpu_torch.eval.evaluator import to_device
from recbole_gnn_tpu_torch.quick_start import create_dataset, data_preparation
from recbole_gnn_tpu_torch.utils import trace
from recbole_gnn_tpu_torch.utils.trace import SpanStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "srgnn-diginetica.train"
READERS = ("session_batch_ms.train", "session_fill.train")
BPR_ONE = {"distribution": "uniform", "sample_num": 1, "dynamic": False}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def _tiny(**port):
    """``portbench/tests/conftest.py``'s tiny overrides of the cell
    (loaded by path: this directory's own ``conftest`` holds the name),
    with ``port`` keys on top."""
    spec = importlib.util.spec_from_file_location(
        "portbench_tests_conftest",
        os.path.join(ROOT, "portbench", "tests", "conftest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    over = mod.tiny(CELL)
    over["port"].update(port)
    return over


def _context(seed=2**31 + 5, **port):
    bench = _bench()
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    return bench_run.Context(bench, cell, seed, 1.0, False,
                             torch.device("cpu"), time.perf_counter(),
                             overrides=_tiny(**port))


def test_port_matches_the_plain_reference(tmp_path):
    ctx = _context()
    ctx.mix["first_steps"] = 1
    s = train.Setup(ctx, str(tmp_path))
    log = ctx.reference.load_log(s.path, ctx.cfg["port"], ctx.seed)
    ref = ctx.reference.Reference(log, ctx.cfg["port"], ctx.device, "f64")
    batch = s.batches[0]
    assert ref.batch_faults(batch) == 0
    params = {k: v.float().requires_grad_(True) for k, v in s.p0.items()}
    loss, _ = s.model.calculate_loss(harness.tree(params), s.model.consts,
                                     s.extras, to_device(batch, ctx.device),
                                     None)
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    rp = {k: v.clone().requires_grad_(True) for k, v in s.p0.items()}
    rloss = ref.loss(rp, batch)
    rgrads = dict(zip(rp, torch.autograd.grad(rloss, list(rp.values()))))
    # float32 against float64: the CE's log-sum-exp over 200 items and
    # 256 rows rounds to a few float32 units of the loss
    assert float(loss.detach()) == pytest.approx(float(rloss.detach()),
                                                 rel=1e-6)
    assert set(grads) == set(rgrads) == set(s.p0)
    for k in s.p0:
        # each element to 1e-4 of itself, or to 1e-6 of the leaf's
        # largest element where float32 cancellation leaves less
        scale = float(rgrads[k].abs().max())
        np.testing.assert_allclose(grads[k].double().numpy(),
                                   rgrads[k].numpy(), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=k)
    # one Adam step of the trainer against the reference's
    losses, _, p_after = train.reference_steps(ref, s.p0, s.batches,
                                               ctx.device)
    assert s.losses[0] == pytest.approx(losses[0], rel=1e-6)
    lr = float(ctx.cfg["port"]["learning_rate"])
    eps = 1e-8
    for k in s.p0:
        step, rstep = s.p_after[k] - s.p0[k], p_after[k] - s.p0[k]
        # a first Adam step is lr·g/(|g| + eps), whose slope in g is
        # lr·eps/(|g| + eps)²: each step is held to the gradient's own
        # tolerance above carried through that slope, plus 1e-5·lr for
        # the trainer's bias corrections in float32 (1 - float32(0.999)
        # is 1.3e-5 off, 6.4e-6 of the step after the square root), plus
        # half a float32 unit of the weight (p - step is rounded once)
        g = rgrads[k].abs()
        dg = 1e-4 * g + 1e-6 * float(g.max())
        tol = (lr * eps * dg / (g + eps) ** 2 + 1e-5 * lr
               + 2.0 ** -24 * float(s.p_after[k].abs().max()))
        gap = (step - rstep).abs()
        assert bool((gap <= tol).all()), (k, float((gap / tol).max()))


def _parent_batches(loader, epoch):
    """The batches of ``loader``'s ``epoch`` as its body made them
    before it opened spans."""
    rng = np.random.default_rng((loader.seed, epoch))
    perm = rng.permutation(loader.n)
    for lo in range(0, loader.n, loader.batch_size):
        rows = perm[lo:lo + loader.batch_size]
        b = _session_batch(loader.dataset, rows)
        if loader.neg_num:
            negs = loader.sampler.sample(b["user_id"], loader.neg_num, rng)
            b["neg_item_id"] = negs[:, 0] if loader.neg_num == 1 else negs
        yield _pad_batch(b, loader.batch_size)


@pytest.mark.parametrize("neg", [None, BPR_ONE], ids=["ce", "bpr"])
def test_session_loader_spans_counters_and_batches(tmp_path, neg):
    ctx = _context(train_neg_sample_args=neg)
    common.write_data(ctx, str(tmp_path))
    config = common.port_config(ctx, str(tmp_path))
    (loader, _), _, _ = data_preparation(config, create_dataset(config))
    assert isinstance(loader, SequentialTrainLoader)
    assert bool(loader.neg_num) == (neg is not None)
    assert loader.n % loader.batch_size            # a padded last batch
    trace.reset()
    got = []
    with trace.span("fit"):
        for _ in range(2):
            with trace.span("epoch"):
                got.append(list(loader))
    for epoch, batches in enumerate(got):
        want = list(_parent_batches(loader, epoch))
        assert len(batches) == len(want) == len(loader)
        for b, w in zip(batches, want):
            assert list(b) == list(w)
            for k in w:
                assert b[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(b[k], w[k], err_msg=k)
    aggs = trace.snapshot()["unprofiled"]
    assert aggs["fit/epoch/shuffle"]["count"] == 2
    flat = [b for batches in got for b in batches]
    batch = aggs["fit/epoch/batch"]
    assert batch["count"] == len(flat)
    real = [b["weight"] > 0 for b in flat]
    L = int(ctx.cfg["port"]["MAX_ITEM_LIST_LENGTH"])
    assert batch["counters"] == {
        "rows": sum(int(r.sum()) for r in real),
        "padded_rows": sum(int((~r).sum()) for r in real),
        "positions": sum(int(b["item_seq_len"][r].sum())
                         for b, r in zip(flat, real)),
        "slots": len(flat) * loader.batch_size * L}
    assert batch["counters"]["rows"] == 2 * loader.n
    if neg is not None:
        assert aggs["fit/epoch/batch/sample"]["count"] == len(flat)


def _store(**aggs):
    """A span store holding the given aggregates: ``path=(count,
    total_ns, counters)``."""
    st = SpanStore()
    for path, (count, total_ns, counters) in aggs.items():
        agg = st._agg(False, path.replace("__", "/"))
        agg.count, agg.total_ns = count, total_ns
        agg.counters.update(counters)
    return st


@pytest.mark.parametrize("name,aggs,want", [
    ("session_batch_ms.train",
     dict(fit__epoch__batch=(8, 6_000_000, {}),
          fit__epoch__shuffle=(1, 2_000_000, {}),
          fit__epoch__step=(8, 40_000_000, {})), 1.0),
    ("session_fill.train",
     dict(fit__epoch__batch=(8, 6_000_000, {"positions": 30, "slots": 160,
                                            "rows": 8, "padded_rows": 0})),
     18.75),
    # the parent's store: a LightGCN-like fit with no session spans
    ("session_batch_ms.train",
     dict(fit__epoch__shuffle=(1, 2_000_000, {}),
          fit__epoch__step=(8, 40_000_000, {})), None),
    ("session_fill.train",
     dict(fit__epoch__step=(8, 40_000_000, {"steps": 8})), None),
    ("session_batch_ms.train", {}, None),
    ("session_fill.train", {}, None),
])
def test_reader_on_a_hand_made_store(monkeypatch, name, aggs, want):
    monkeypatch.setattr(trace, "snapshot", _store(**aggs).snapshot)
    value = harness.load_module("metrics", name).read(None)
    assert value == (None if want is None else pytest.approx(want))


def test_a_tiny_traced_run_reads_both():
    over = _tiny()
    over["mix"].update(trace_at=0.8, trace_s=0.1)
    trace.reset()
    res = bench_run.run_cell(_bench(), CELL, 2**31 + 17, 1.5, True,
                             torch.device("cpu"), time.perf_counter(),
                             overrides=over)
    assert res["correct"] is True, res["checks"]
    for name in READERS:
        assert name in res["cpu_dry_run"]["readers"], name
    batch_ms, fill = (harness.load_module("metrics", n).read(None)
                      for n in READERS)
    assert math.isfinite(batch_ms) and batch_ms > 0
    assert 0 < fill < 100
