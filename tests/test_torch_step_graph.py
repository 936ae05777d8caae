"""The training step as a CUDA graph (``train/step_graph.py``) and what
it rests on.

On the CPU:

* Adam counts its step ``t`` up in place: the same tensor object across
  updates, and params, ``m``, ``v`` and ``t`` bit for bit those of the
  update that rebinds ``t``; the other learners rebind no state leaf.
* A CPU ``fit`` stays eager: ``fit/epoch/step`` counts ``steps`` equal
  to its steps and no ``replayed``, with one ``forward``, ``backward``
  and ``optimizer`` span a step.
* ``step_replay_share.train``'s reader: None without a ``fit/epoch/step``
  counter, 0.0 after a CPU ``fit``.

On the card (marked ``cuda``; skipped without one; run there with
``python -m pytest --noconftest tests/test_torch_step_graph.py``, since
this directory's ``conftest.py`` imports JAX):

* LightGCN on ``ell``: 20 steps through ``train_step`` (1 eager, then
  captured and replayed) against 20 eager steps from the same state,
  bit for bit in losses, params, ``m``, ``v`` and ``t``.  The kernel
  wrappers count the launches of the observed step and of the capture,
  as many as the first two eager steps, and none in a replay.
* SimGCL's step draws from the epoch's generator: it stays eager.
* A new state (a resume) is captured again, and the old graph is freed.
* SR-GNN's step is captured at its second step.
* Every model fits two epochs by the rule, no capture raising: the 11
  models whose steps draw nothing from a host generator are captured,
  each captured state after one eager step, and the other 14 stay
  eager.

No JAX here: the card's machine has none.
"""

import gc
import os
import weakref

import numpy as np
import pytest
import torch

from portbench import harness
from recbole_gnn_tpu_torch.config import Config
from recbole_gnn_tpu_torch.eval.evaluator import to_device
from recbole_gnn_tpu_torch.models import all_model_names, get_model
from recbole_gnn_tpu_torch.ops.ell_spmm import ell_spmm, ell_spmm_transpose
from recbole_gnn_tpu_torch.quick_start import create_dataset, data_preparation
from recbole_gnn_tpu_torch.train.optim import (make_optimizer, tree_leaves,
                                               tree_map)
from recbole_gnn_tpu_torch.train.trainer import Trainer
from recbole_gnn_tpu_torch.utils import trace

TEST_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "test_data")
ELL = {"enable_sparse": True, "sparse_spmm_impl": "ell"}
# models on a sparse graph where they have one, and the overrides that
# reach their full losses on the fixture within two epochs
SPARSE = {"LightGCN", "NGCF", "SGL", "SimGCL", "XSimGCL", "NCL", "HMLET",
          "DirectAU", "LightGCL", "DiffNet", "MHCN", "SEPT"}
OVER = {"NCL": {"num_clusters": 10, "warm_up_step": 0},
        "HMLET": {"warm_up_epochs": -1}, "SEPT": {"warm_up_epochs": 0},
        "DirectAU": {"encoder": "LightGCN"}}
# the models whose steps draw nothing from a host generator and make no
# synchronizing call, so that the rule captures them
CAPTURED = {"LightGCN", "BPR", "DiffNet", "DirectAU", "LightGCL", "SGL",
            "NCL", "SEPT", "SRGNN", "SGNNHN", "TAGNN"}


def _config(tmp_path, model, use_gpu, **over):
    cd = {"model": model, "dataset": "test", "data_path": TEST_DATA,
          "epochs": 1, "state": "ERROR", "train_batch_size": 256,
          "eval_batch_size": 256, "MAX_ITEM_LIST_LENGTH": 20,
          "checkpoint_dir": str(tmp_path), "embedding_size": 16,
          "n_layers": 2, "seed": 7, "use_gpu": use_gpu}
    cd.update(over)
    return Config(config_dict=cd)


def _trainer(cfg, device=None):
    (train, train_ds), (valid, _), _ = data_preparation(
        cfg, create_dataset(cfg))
    model = get_model(cfg["model"])(cfg, train_ds, device)
    return Trainer(cfg, model), train, valid


def _batches(loader, n: int) -> list[dict]:
    out = []
    while len(out) < n:
        for b in loader:
            out.append(b)
            if len(out) == n:
                break
    return out


def _fresh_state(trainer, seed: int = 3):
    params = trainer.model.init_params(torch.Generator().manual_seed(seed))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params, trainer.optimizer.init(params)


def _copy_state(params, opt_state):
    params = tree_map(lambda v: v.detach().clone().requires_grad_(True),
                      params)
    return params, tree_map(torch.clone, opt_state)


def _aggs(path: str) -> list[dict]:
    # a path's aggregates in both buckets, outside a profiler and in one
    return [b[path] for b in trace.snapshot().values() if path in b]


def _step_counters(path: str = "step") -> dict:
    out = {}
    for agg in _aggs(path):
        for k, n in agg["counters"].items():
            out[k] = out.get(k, 0) + n
    return out


def _span_count(path: str) -> int:
    return sum(agg["count"] for agg in _aggs(path))


# -- CPU ---------------------------------------------------------------

def _rebinding_adam(lr, weight_decay, clip, b1=0.9, b2=0.999, eps=1e-8):
    """Adam's update as it was before ``t`` counted in place: a new
    ``t`` each step, bound into the state."""
    def update(grads, state, params):
        with torch.no_grad():
            gs = tree_leaves(grads)
            if clip:
                gnorm = torch.sqrt(sum((g * g).sum() for g in gs))
                scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12),
                                    max=1.0)
                gs = [g * scale for g in gs]
            if weight_decay:
                gs = [g + weight_decay * p
                      for g, p in zip(gs, tree_leaves(params))]
            t = state["t"] + 1
            tf = t.to(torch.float32)
            bc1 = 1 - torch.full((), b1, dtype=torch.float32) ** tf
            bc2 = 1 - torch.full((), b2, dtype=torch.float32) ** tf
            for p, g, m, v in zip(tree_leaves(params), gs,
                                  tree_leaves(state["m"]),
                                  tree_leaves(state["v"])):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
            state["t"] = t
    return update


@pytest.mark.parametrize("weight_decay,clip", [(0.0, None), (1e-4, 0.5)])
def test_adam_counts_t_in_place_with_the_same_values(weight_decay, clip):
    gen = torch.Generator().manual_seed(11)
    params = {"a": torch.randn(7, 4, generator=gen),
              "b": [torch.randn(5, generator=gen)]}
    grads = [tree_map(lambda v: torch.randn(v.shape, generator=gen), params)
             for _ in range(3)]
    opt = make_optimizer("adam", lr=1e-2, weight_decay=weight_decay,
                         clip_grad_norm=clip)
    ref_params = tree_map(torch.clone, params)
    state, ref_state = opt.init(params), opt.init(ref_params)
    t_obj, leaves = state["t"], tree_leaves(state)
    ref_update = _rebinding_adam(1e-2, weight_decay, clip)
    for g in grads:
        opt.update(g, state, params)
        ref_update(g, ref_state, ref_params)
        assert state["t"] is t_obj
        assert all(a is b for a, b in zip(tree_leaves(state), leaves))
    assert t_obj.dtype == torch.int32 and int(t_obj) == 3
    for a, b in zip(tree_leaves((params, state)),
                    tree_leaves((ref_params, ref_state))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("learner", ["sgd", "adagrad", "rmsprop"])
def test_other_learners_rebind_no_state_leaf(learner):
    params = {"a": torch.ones(3, 2), "b": torch.full((4,), 2.0)}
    opt = make_optimizer(learner, lr=0.1)
    state = opt.init(params)
    keys, leaves = sorted(state), tree_leaves(state)
    for _ in range(3):
        opt.update(tree_map(torch.ones_like, params), state, params)
    assert sorted(state) == keys
    assert all(a is b for a, b in zip(tree_leaves(state), leaves))


@pytest.mark.parametrize("graph", ["dense", "ell"])
def test_a_cpu_fit_stays_eager(tmp_path, graph):
    cfg = _config(tmp_path, "LightGCN", False, epochs=2,
                  **(ELL if graph == "ell" else {}))
    trainer, train, valid = _trainer(cfg, torch.device("cpu"))
    trace.reset()
    trainer.fit(train, valid, saved=False, verbose=False)
    steps = 2 * len(train)
    assert _step_counters("fit/epoch/step") == {"steps": steps}
    for phase in ("forward", "backward", "optimizer"):
        assert _span_count(f"fit/epoch/step/{phase}") == steps, phase
    for path in ("fit/epoch/step/observe", "fit/epoch/step/capture",
                 "fit/epoch/step/replay"):
        assert _span_count(path) == 0, path


def test_step_replay_share_reader(tmp_path):
    reader = harness.load_module("metrics", "step_replay_share.train")
    trace.reset()
    with trace.span("step"):
        trace.count("steps", 1)
    assert reader.read(None) is None
    cfg = _config(tmp_path, "LightGCN", False)
    trainer, train, _ = _trainer(cfg, torch.device("cpu"))
    trainer.fit(train, None, saved=False, verbose=False)
    assert reader.read(None) == 0.0


# -- the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_replayed_steps_equal_eager_steps(tmp_path, card):
    cfg = _config(tmp_path, "LightGCN", True, **ELL)
    trainer, train, _ = _trainer(cfg)
    model = trainer.model
    params, opt_state = _fresh_state(trainer)
    eager_params, eager_state = _copy_state(params, opt_state)
    batches = [to_device(b, card) for b in _batches(train, 20)]
    # LightGCN draws nothing from it: both sides may share it
    rng = torch.Generator().manual_seed(5)
    trace.reset()
    sides = {
        "graph": lambda b: trainer.train_step(params, opt_state,
                                              model.consts, {}, b, rng),
        "eager": lambda b: trainer._eager_step(
            eager_params, eager_state, model.consts, {}, b, rng, 0)}
    losses, launches = {}, {}
    for side, step in sides.items():
        n0 = (ell_spmm.launches, ell_spmm_transpose.launches)
        out = [step(b) for b in batches[:2]]
        n1 = (ell_spmm.launches, ell_spmm_transpose.launches)
        out += [step(b) for b in batches[2:]]
        n2 = (ell_spmm.launches, ell_spmm_transpose.launches)
        losses[side] = [float(v) for v in out]
        launches[side] = (np.subtract(n1, n0).tolist(),
                          np.subtract(n2, n1).tolist())
    torch.cuda.synchronize(card)
    assert _step_counters() == {"steps": 20, "captures": 1, "replayed": 19}
    assert _span_count("step/observe") == _span_count("step/capture") == 1
    # the observed step and the capture launch through the wrappers as
    # the first two eager steps do; a replay launches through none
    assert launches["graph"][0] == launches["eager"][0]
    assert launches["graph"][1] == [0, 0]
    assert launches["eager"][1] == [9 * n for n in launches["eager"][0]]
    assert losses["graph"] == losses["eager"]
    got = tree_leaves((params, opt_state))
    want = tree_leaves((eager_params, eager_state))
    assert int(opt_state["t"]) == 20
    for a, b in zip(got, want):
        assert torch.equal(a, b), float((a - b).abs().max())


@pytest.mark.cuda
def test_a_step_that_draws_from_the_generator_stays_eager(tmp_path, card):
    cfg = _config(tmp_path, "SimGCL", True, **ELL)
    trainer, train, _ = _trainer(cfg)
    params, opt_state = _fresh_state(trainer)
    rng = torch.Generator().manual_seed(5)
    trace.reset()
    for b in _batches(train, 4):
        loss = trainer.train_step(params, opt_state, trainer.model.consts,
                                  {}, to_device(b, card), rng)
        assert torch.isfinite(loss)
    assert _step_counters() == {"steps": 4}
    assert _span_count("step/capture") == 0
    # the observed step's phases under ``observe``, the others' not
    assert _span_count("step/observe/forward") == 1
    assert _span_count("step/forward") == 3


@pytest.mark.cuda
def test_a_new_state_is_captured_again_and_frees_the_old(tmp_path, card):
    cfg = _config(tmp_path, "LightGCN", True, **ELL)
    trainer, train, _ = _trainer(cfg)
    params, opt_state = _fresh_state(trainer)
    batches = [to_device(b, card) for b in _batches(train, 3)]
    rng = torch.Generator().manual_seed(5)
    trace.reset()
    for b in batches:
        trainer.train_step(params, opt_state, trainer.model.consts, {}, b,
                           rng)
    old = weakref.ref(trainer._graphs._states[0].graph)
    # a resume hands the trainer new tensors of the same values
    params, opt_state = _copy_state(params, opt_state)
    for b in batches:
        trainer.train_step(params, opt_state, trainer.model.consts, {}, b,
                           rng)
    gc.collect()
    assert old() is None
    assert _span_count("step/capture") == 2
    assert _step_counters() == {"steps": 6, "captures": 2, "replayed": 4}
    assert int(opt_state["t"]) == 6


@pytest.mark.cuda
def test_srgnn_is_captured_at_its_second_step(tmp_path, card):
    cfg = _config(tmp_path, "SRGNN", True, hidden_size=16)
    trainer, train, _ = _trainer(cfg)
    params, opt_state = _fresh_state(trainer)
    rng = torch.Generator().manual_seed(5)
    trace.reset()
    for b in _batches(train, 4):
        loss = trainer.train_step(params, opt_state, trainer.model.consts,
                                  {}, to_device(b, card), rng)
        assert torch.isfinite(loss)
    assert _step_counters() == {"steps": 4, "captures": 1, "replayed": 3}
    assert _span_count("step/capture") == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", all_model_names())
def test_every_model_fits_by_the_rule(tmp_path, card, name):
    cfg = _config(tmp_path, name, True, epochs=2, **OVER.get(name, {}),
                  **(ELL if name in SPARSE else {}))
    trainer, train, _ = _trainer(cfg)
    trace.reset()
    trainer.fit(train, None, saved=False, verbose=False)
    counters = _step_counters("fit/epoch/step")
    captures = _span_count("fit/epoch/step/capture")
    replayed = counters.get("replayed", 0)
    assert counters["steps"] == 2 * len(train)
    assert (replayed > 0) == (captures > 0) == (name in CAPTURED)
    assert counters.get("captures", 0) == captures
    # each capture follows an eager step of its state
    assert replayed <= counters["steps"] - captures
    assert all(torch.isfinite(p).all() for p in tree_leaves(trainer.params)
               if p.is_floating_point())
