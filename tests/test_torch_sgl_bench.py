"""SGL-ED on the Gowalla shape, the benchmark's ``sgl-gowalla``
configuration, at a tiny size on the CPU.

* The plain reference ``portbench/reference/sgl.py`` reads the
  training interactions in the program's order and draws the program's
  two set-up views from the run's seed, mask for mask.
* The cell's run: the program's set-up steps and first validation
  against the reference are ``correct`` (``runners/train.py``'s
  ``compare``), and each planted fault (view 2 drawn from another seed,
  view 1 for both views, in-batch InfoNCE negatives in place of every
  node, half of each batch) fails a limit, and so do the TF32 control
  and ``calibrate``'s faults.
* ``flops_per_step`` and ``spmm_calls`` against a count by hand.
* The tracing: ``fit`` opens ``fit/epoch_start`` once an epoch; SGL
  counts two ``views`` an epoch there, ``kept_edges`` over ``edges``
  near 1 − ρ; on the card ``StepGraphs`` counts one ``captures`` a
  capture, one an epoch of new views; the readers of
  ``epoch_start_ms.train`` and
  ``captures_per_epoch.train`` on hand-made span stores.

The card's tests are marked ``cuda`` and skip without one; on the card
``python -m pytest --noconftest tests/test_torch_sgl_bench.py`` (this
directory's ``conftest.py`` imports JAX, which the card's machine
lacks).  No JAX here.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import recbole_gnn_tpu_torch.models.general.sgl as sgl_mod
from portbench import calibrate, harness
from portbench import run as bench_run
from portbench.runners import common
from recbole_gnn_tpu_torch.config import Config
from recbole_gnn_tpu_torch.eval.evaluator import to_device
from recbole_gnn_tpu_torch.models import get_model
from recbole_gnn_tpu_torch.models.general.sgl import SGL
from recbole_gnn_tpu_torch.quick_start import create_dataset, data_preparation
from recbole_gnn_tpu_torch.train.optim import tree_leaves
from recbole_gnn_tpu_torch.train.trainer import Trainer
from recbole_gnn_tpu_torch.utils import trace
from recbole_gnn_tpu_torch.utils.trace import SpanStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_DATA = os.path.join(ROOT, "tests", "test_data")
CELL = "sgl-gowalla.train"
SEED = 2**31 + 5
# the configuration at a size the CPU runs in seconds: the widths as
# configured, the log and the batch small
TINY = {"data": {"shape": {"n_users": 300, "n_items": 500, "n_inter": 6000}},
        "port": {"train_batch_size": 256}}
TINY_MIX = {"trace_at": 0.3, "trace_s": 0.3}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def _tiny():
    over = {k: {kk: dict(vv) if isinstance(vv, dict) else vv
                for kk, vv in v.items()} for k, v in TINY.items()}
    over["mix"] = dict(TINY_MIX)
    return over


def _context(seed=SEED, device=torch.device("cpu")):
    bench = _bench()
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    return bench_run.Context(bench, cell, seed, 1.0, False, device,
                             time.perf_counter(), overrides=_tiny())


def _run(seed=SEED, traced=False):
    return bench_run.run_cell(_bench(), CELL, seed, 1.0, traced,
                              torch.device("cpu"), time.perf_counter(),
                              overrides=_tiny())


def _program(ctx, root):
    """(the program's SGL on the cell's tiny log, its training loader,
    the log's path)."""
    path = common.write_data(ctx, root)
    config = common.port_config(ctx, root)
    (train, train_ds), _, _ = data_preparation(config,
                                               create_dataset(config))
    return get_model("SGL")(config, train_ds, ctx.device), train, path


# -- the reference's views -----------------------------------------------

@pytest.fixture(params=["cpu", "cuda"])
def device(request):
    if request.param == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        return torch.device("cuda", 0)
    return torch.device("cpu")


def test_the_reference_draws_the_programs_views(tmp_path, monkeypatch,
                                               device):
    ctx = _context(device=device)
    model, _, path = _program(ctx, str(tmp_path))
    drawn = []
    keep_mask = SGL._keep_mask

    def spy(self, *args):
        drawn.append(keep_mask(self, *args))
        return drawn[-1]

    monkeypatch.setattr(SGL, "_keep_mask", spy)
    extras = model.init_extras(torch.Generator().manual_seed(ctx.seed))
    log = ctx.reference.load_log(path, ctx.cfg["port"], ctx.seed)
    # the training interactions in the program's order
    np.testing.assert_array_equal(model.consts["aug_users"].cpu().numpy(),
                                  log.users[log.train_rows])
    np.testing.assert_array_equal(model.consts["aug_items"].cpu().numpy(),
                                  log.items[log.train_rows])
    ref = ctx.reference.Reference(log, ctx.cfg["port"], device, "f64")
    assert len(drawn) == len(ref.keeps) == 2
    for got, want in zip(drawn, ref.keeps):
        assert got.device == want.device
        assert torch.equal(got, want)
    # each view's graph weights: the reference's, edge for edge
    g = model.consts["graph"]
    for name, (src, dst, w) in zip(("view1", "view2"), ref.views):
        n = g.n_edges
        got = {(int(s), int(d)): float(x) for s, d, x in zip(
            g.src[:n].tolist(), g.dst[:n].tolist(),
            extras[name][0][:n].tolist()) if x > 0}
        want = dict(zip(zip(src.tolist(), dst.tolist()), w.tolist()))
        assert got.keys() == want.keys()
        assert all(abs(got[k] - want[k]) <= 1e-6 * want[k] for k in want)


# -- the cell's run -------------------------------------------------------

def test_the_set_up_steps_match_the_reference():
    res = _run()
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {"shape", "batches", "loss", "grad",
                                  "change", "valid"}


def _other_seed_view(monkeypatch):
    init = SGL.init_extras

    def other(self, gen, keeps=None):
        out = init(self, gen, keeps)
        again = init(self, torch.Generator().manual_seed(
            gen.initial_seed() + 1), keeps)
        out.update({k: v for k, v in again.items()
                    if k.startswith("view2")})
        return out

    monkeypatch.setattr(SGL, "init_extras", other)


def _view1_twice(monkeypatch):
    forward_view = SGL._forward_view
    monkeypatch.setattr(SGL, "_forward_view",
                        lambda self, p, c, e, name: forward_view(
                            self, p, c, e, "view1"))


def _in_batch_negatives(monkeypatch):
    info_nce = sgl_mod.info_nce
    monkeypatch.setattr(sgl_mod, "info_nce",
                        lambda *a, all_view2=None, **kw: info_nce(*a, **kw))


def _half_batch(monkeypatch):
    loss = SGL.calculate_loss

    def half(self, params, consts, extras, batch, rng, mode=0):
        b = dict(batch)
        w = b["weight"].clone()
        w[len(w) // 2:] = 0.0
        b["weight"] = w
        return loss(self, params, consts, extras, b, rng, mode=mode)

    monkeypatch.setattr(SGL, "calculate_loss", half)


@pytest.mark.parametrize("plant", [_other_seed_view, _view1_twice,
                                   _in_batch_negatives, _half_batch],
                         ids=["other_seed_view", "view1_twice",
                              "in_batch_negatives", "half_batch"])
def test_a_planted_fault_fails_a_limit(monkeypatch, plant):
    plant(monkeypatch)
    res = _run()
    assert not res["correct"]
    failed = [k for k, c in res["checks"].items() if not c["ok"]]
    assert set(failed) <= {"loss", "grad", "change", "valid"}, failed


def test_the_control_and_the_calibrated_faults_fail_a_limit():
    ctx = _context(seed=2**31 + 6)
    out = calibrate.train_readings(ctx, control=True)
    assert all(v <= ctx.limits[k] for k, v in out["program"].items()
               if k in ctx.limits), out["program"]
    for kind in ("control", "fault_half_batch", "fault_answer",
                 "fault_unchanged"):
        assert any(v > ctx.limits[k] for k, v in out[kind].items()
                   if k in ctx.limits), (kind, out[kind])


# -- the operation counts ---------------------------------------------------

def test_flops_and_spmm_calls_by_hand(tmp_path, monkeypatch):
    ctx = _context()
    model, train, path = _program(ctx, str(tmp_path))
    R = ctx.reference
    log = R.load_log(path, ctx.cfg["port"], ctx.seed)
    shp = R.shapes(log, ctx.cfg["port"])
    n_train = len(log.train_rows)
    n_users, n_items = 301, 501          # the tiny log's ids and PAD
    assert (shp["n_users"], shp["n_items"]) == (n_users, n_items)
    assert shp["n_edges"] == 2 * n_train == model.consts["graph"].n_edges
    n = n_users + n_items
    assert R.spmm_calls(shp) == (n, n, 2 * n_train)
    # 18 SpMMs of 2·E·64, the (256 × 802) logits GEMMs forward and
    # back, four dot products forward and back
    e = 2 * n_train
    want = 18 * 2 * e * 64 + 3 * 2 * 256 * n * 64 + 4 * 3 * 2 * 256 * 64
    assert R.flops_per_step(shp) == want
    # a step's forward propagates nine times: three graphs, three layers
    calls = []
    spmm_any = sgl_mod.spmm_any
    monkeypatch.setattr(sgl_mod, "spmm_any",
                        lambda g, x: calls.append(g) or spmm_any(g, x))
    params = model.init_params(torch.Generator().manual_seed(1))
    extras = model.init_extras(torch.Generator().manual_seed(2))
    batch = to_device(next(iter(train)), ctx.device)
    model.calculate_loss(params, model.consts, extras, batch, None)
    assert len(calls) == 9


# -- the tracing -------------------------------------------------------------

def _aggs():
    return trace.snapshot()["unprofiled"]


@pytest.mark.parametrize("name", ["SGL", "LightGCN"])
def test_fit_opens_epoch_start_once_an_epoch(tmp_path, name):
    cfg = Config(config_dict={
        "model": name, "dataset": "test", "data_path": TEST_DATA,
        "epochs": 3, "state": "ERROR", "train_batch_size": 256,
        "checkpoint_dir": str(tmp_path), "embedding_size": 16,
        "n_layers": 2, "seed": 7, "use_gpu": False, "enable_sparse": True,
        "sparse_spmm_impl": "ell"})
    (train, train_ds), (valid, _), _ = data_preparation(
        cfg, create_dataset(cfg))
    trainer = Trainer(cfg, get_model(name)(cfg, train_ds,
                                           torch.device("cpu")))
    trace.reset()
    trainer.fit(train, valid, saved=False, verbose=False)
    aggs = _aggs()
    assert aggs["fit/epoch_start"]["count"] == aggs["fit/epoch"]["count"] \
        == 3
    counters = aggs["fit/epoch_start"]["counters"]
    if name == "LightGCN":
        assert counters == {}
    else:
        # each epoch_start counts the two views built before it
        assert counters["views"] == 6


def test_sgl_counts_its_views_and_kept_edges(tmp_path):
    ctx = _context()
    model, train, _ = _program(ctx, str(tmp_path))
    trainer = Trainer(model.config, model)
    trainer.epochs = 4
    trace.reset()
    trainer.fit(train, None, saved=False, verbose=False)
    counters = _aggs()["fit/epoch_start"]["counters"]
    n_train = model.consts["aug_users"].shape[0]
    assert counters["views"] == 2 * 4
    assert counters["edges"] == 2 * 4 * 2 * n_train
    # 4,800 training interactions a view: 1 - rho within 2 %
    assert counters["kept_edges"] / counters["edges"] == pytest.approx(
        1 - model.drop_ratio, abs=0.02)
    assert all(torch.isfinite(p).all() for p in tree_leaves(trainer.params))


@pytest.mark.cuda
def test_step_graphs_count_one_capture_a_capture(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda", 0)
    cfg = Config(config_dict={
        "model": "SGL", "dataset": "test", "data_path": TEST_DATA,
        "state": "ERROR", "train_batch_size": 256,
        "checkpoint_dir": str(tmp_path), "embedding_size": 16,
        "n_layers": 2, "seed": 7, "use_gpu": True, "enable_sparse": True,
        "sparse_spmm_impl": "ell"})
    (train, train_ds), _, _ = data_preparation(cfg, create_dataset(cfg))
    model = get_model("SGL")(cfg, train_ds, card)
    trainer = Trainer(cfg, model)
    params = model.init_params(torch.Generator().manual_seed(3))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt_state = trainer.optimizer.init(params)
    batch = to_device(next(iter(train)), card)
    rng = torch.Generator().manual_seed(5)
    trace.reset()
    for epoch in range(4):
        # new views each epoch: a new state, observed, captured, replayed
        extras = model.epoch_start(epoch, params, model.consts, {}, rng)
        for _ in range(3):
            trainer.train_step(params, opt_state, model.consts, extras,
                               batch, rng)
    aggs = trace.snapshot()["unprofiled"]
    assert aggs["step"]["counters"] == {"steps": 12, "captures": 4,
                                        "replayed": 8}
    assert aggs["step/capture"]["count"] == 4


# -- the readers -------------------------------------------------------------

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
    ("epoch_start_ms.train",
     dict(fit__epoch_start=(2, 30_000_000, {"views": 4}),
          fit__epoch__step=(10, 40_000_000, {"steps": 10})), 3.0),
    ("captures_per_epoch.train",
     dict(fit__epoch=(4, 9_000_000_000, {}),
          fit__epoch__step=(100, 40_000_000, {"steps": 100,
                                              "captures": 3})), 0.75),
    # the parent's store: no epoch_start span, no captures counter
    ("epoch_start_ms.train",
     dict(fit__epoch=(4, 9_000_000_000, {}),
          fit__epoch__step=(100, 40_000_000, {"steps": 100})), None),
    ("captures_per_epoch.train",
     dict(fit__epoch=(4, 9_000_000_000, {}),
          fit__epoch__step=(100, 40_000_000, {"steps": 100,
                                              "replayed": 96})), None),
    ("epoch_start_ms.train", {}, None),
    ("captures_per_epoch.train", {}, None),
])
def test_reader_on_a_hand_made_store(monkeypatch, name, aggs, want):
    monkeypatch.setattr(trace, "snapshot", _store(**aggs).snapshot)
    value = harness.load_module("metrics", name).read(None)
    assert value == (None if want is None else pytest.approx(want))


def test_a_tiny_traced_run_reads_epoch_start():
    trace.reset()
    res = _run(seed=2**31 + 17, traced=True)
    assert res["correct"] is True, res["checks"]
    assert "epoch_start_ms.train" in res["cpu_dry_run"]["readers"]
    # a CPU run never captures: the capture reader finds nothing
    assert "captures_per_epoch.train" not in res["cpu_dry_run"]["readers"]
    ms = harness.load_module("metrics", "epoch_start_ms.train").read(None)
    assert ms is not None and ms > 0
