"""Port parity: the training slice — losses and their gradients, the
optimizers, the train loader, and the trainer from a JAX-written
checkpoint to epoch 3 on the dense and the sparse graph (``pallas``
and ``xla``), in process and through the port's CLI.

The port runs on the CPU here (``use_gpu=False``): a sparse graph's
backward is the plain transpose SpMM over the reverse CSR (``xla``: the
plain versions of its row gather and block segment sum).  Tolerances:
losses and gradients rtol 1e-5 / atol 1e-6 (the same f32 sums in
another order); optimizer states rtol 1e-6 (atol: ``OPT_ATOL``); trained params rtol 1e-4
after ~20 Adam steps; test metrics abs 1e-3 (a rank can flip on a
near-tie when params differ in the 6th digit).
"""

import importlib
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import base_config_dict
from recbole_gnn_tpu.config import Config as JConfig
from recbole_gnn_tpu.models import get_model as j_get_model
from recbole_gnn_tpu.quick_start import create_dataset as j_create_dataset
from recbole_gnn_tpu.quick_start import data_preparation as j_data_preparation
from recbole_gnn_tpu.train.checkpoint import load_checkpoint as j_load
from recbole_gnn_tpu.train.optim import make_optimizer as j_make_optimizer
from recbole_gnn_tpu.train.trainer import Trainer as JTrainer
from recbole_gnn_tpu_torch.config import Config as TConfig
from recbole_gnn_tpu_torch.eval.evaluator import to_device
from recbole_gnn_tpu_torch.models import get_model as t_get_model
from recbole_gnn_tpu_torch.quick_start import create_dataset as t_create_dataset
from recbole_gnn_tpu_torch.quick_start import data_preparation as t_data_preparation
from recbole_gnn_tpu_torch.train.checkpoint import params_from_numpy
from recbole_gnn_tpu_torch.train.optim import make_optimizer as t_make_optimizer
from recbole_gnn_tpu_torch.train.trainer import Trainer as TTrainer

# by module path: the JAX ops package re-exports a function named spmm
j_spmm_mod = importlib.import_module("recbole_gnn_tpu.ops.spmm")
j_pallas_mod = importlib.import_module("recbole_gnn_tpu.ops.pallas_spmm")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPARSE = {"enable_sparse": True, "sparse_spmm_impl": "pallas"}
XLA = {"enable_sparse": True, "sparse_spmm_impl": "xla"}
GRAPHS = {"dense": {}, "sparse": SPARSE, "xla": XLA}


def _cfg(**over):
    cd = dict(model="LightGCN", embedding_size=16, n_layers=3, seed=2020,
              use_gpu=False)
    return base_config_dict(**dict(cd, **over))


def _jax_globals(mp):
    """The JAX package's create_dataset sets module globals: restore
    them when the context ends, so later JAX tests see the defaults."""
    mp.setattr(j_spmm_mod, "SPMM_IMPL", j_spmm_mod.SPMM_IMPL)
    mp.setattr(j_pallas_mod, "DEFAULT_PRECISION",
               j_pallas_mod.DEFAULT_PRECISION)


def _both(cd):
    """(JAX, port) × (config, loaders, model) built from one dict."""
    out = []
    for cfg_cls, create, prep, get_model in (
            (JConfig, j_create_dataset, j_data_preparation, j_get_model),
            (TConfig, t_create_dataset, t_data_preparation, t_get_model)):
        c = cfg_cls(config_dict=cd)
        (tl, tr), (vl, _), (te, _) = prep(c, create(c))
        out.append((c, (tl, vl, te), get_model(c["model"])(c, tr)))
    return out


# -- losses and their gradients -------------------------------------------

LOSS_CASES = [("LightGCN", {}, True), ("LightGCN", {}, False),
              ("LightGCN", SPARSE, True), ("LightGCN", SPARSE, False),
              ("BPR", {}, True)]


@pytest.mark.parametrize("model,over,require_pow", LOSS_CASES,
                         ids=["lgcn-dense-pow", "lgcn-dense-nopow",
                              "lgcn-sparse-pow", "lgcn-sparse-nopow", "bpr"])
def test_calculate_loss_matches_jax(monkeypatch, model, over, require_pow):
    _jax_globals(monkeypatch)
    cd = _cfg(model=model, require_pow=require_pow, **over)
    (jc, (jtl, _, _), jm), (tc, _, tm) = _both(cd)
    batch = list(jtl)[-1]                  # the padded last batch
    assert (batch["weight"] == 0).sum() > 0
    jp = jm.init_params(jax.random.PRNGKey(3))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    for v in tp.values():
        v.requires_grad_(True)

    def j_loss(p):
        return jm.calculate_loss(p, jm.consts, {},
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 jax.random.PRNGKey(0))

    (jl, jaux), jg = jax.value_and_grad(j_loss, has_aux=True)(jp)
    tl, taux = tm.calculate_loss(tp, tm.consts, {}, to_device(batch, "cpu"),
                                 None)
    keys = sorted(tp)
    tg = torch.autograd.grad(tl, [tp[k] for k in keys])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-6)
    assert taux.keys() == jaux.keys()
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k, g in zip(keys, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# -- optimizers ----------------------------------------------------------------

# the clip's global norm is a sum reduced in another order in each
# package: one ulp of it moves a param of |p| ~ 1 by one ulp (1.2e-7),
# which rtol alone cannot hold where a param has cancelled toward 0
OPT_ATOL = 2.5e-7

@pytest.mark.parametrize("clip,wd", [(None, 0.0), (0.5, 0.0), (None, 0.01),
                                     (0.5, 0.01)])
@pytest.mark.parametrize("learner", ["adam", "sgd", "adagrad", "rmsprop"])
def test_optimizer_matches_jax(learner, clip, wd):
    rng = np.random.default_rng(5)
    shapes = {"user_emb": (6, 3), "nested": {"w": (4,), "b": (2, 2)}}

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict)
                else rng.normal(size=v).astype(np.float32)
                for k, v in tree.items()}

    p0, grads = draw(shapes), [draw(shapes) for _ in range(5)]
    kw = dict(learner=learner, lr=0.05, weight_decay=wd, clip_grad_norm=clip)
    jopt, topt = j_make_optimizer(**kw), t_make_optimizer(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = params_from_numpy(p0, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp2, ts = topt.update(params_from_numpy(g, "cpu"), ts, tp)
        assert tp2 is tp                       # updated in place

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {kk: vv for k, v in tree.items()
                    for kk, vv in flat(v, f"{prefix}{k}/").items()}
        return {prefix: np.asarray(tree.detach() if isinstance(
            tree, torch.Tensor) else tree)}

    jf, tf = flat({"p": jp, "s": js}), flat({"p": tp, "s": ts})
    assert jf.keys() == tf.keys()
    for k in jf:
        assert tf[k].dtype == jf[k].dtype, k
        np.testing.assert_allclose(tf[k], jf[k], rtol=1e-6, atol=OPT_ATOL,
                                   err_msg=k)
    if learner == "adam":
        assert ts["t"].dtype == torch.int32 and int(ts["t"]) == 5


# -- the train loader -----------------------------------------------------

def test_train_loader_batches_equal_jax():
    cd = _cfg(train_batch_size=700)
    (_, (jtl, _, _), _), (_, (ttl, _, _), _) = _both(cd)
    for epoch in (0, 1):
        jb, tb = list(jtl), list(ttl)
        assert len(jb) == len(tb) == len(ttl) > 1
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=f"{epoch}:{k}")
    assert ttl.epoch == 2


# -- the trainer: JAX checkpoint → epoch 3 in both packages ----------------

def _losses(path):
    with open(path) as f:
        return [r["loss"] for r in map(json.loads, f)
                if r["event"] == "train_epoch"]


@pytest.fixture(scope="module", params=list(GRAPHS))
def resumed(request, tmp_path_factory):
    """A JAX trainer runs epoch 0 and saves; both packages resume from
    that checkpoint and train to epoch 3, the port also through its CLI
    (``runs["cli"]``: the CLI's per-epoch losses)."""
    tmp = tmp_path_factory.mktemp(f"resume_{request.param}")
    cd = _cfg(checkpoint_dir=str(tmp), **GRAPHS[request.param])
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        _jax_globals(mp)
        (jc, (tl, vl, _), jm), _ = _both(dict(cd, epochs=1))
        JTrainer(jc, jm).fit(tl, vl, saved=True, verbose=False)
        ckpt = j_load(str(tmp / "LightGCN-test.ckpt"))
        for name, (c, (tl, vl, te), m), trainer_cls in zip(
                ("jax", "torch"),
                _both(dict(cd, epochs=3,
                           metrics_log_path=str(tmp / "log.jsonl"))),
                (JTrainer, TTrainer)):
            c["metrics_log_path"] = str(tmp / f"{name}.jsonl")
            tr = trainer_cls(c, m)
            tr.fit(tl, vl, saved=False, verbose=False, resume=True)
            runs[name] = (tr, tr.evaluate(te, load_best_model=False),
                          _losses(tmp / f"{name}.jsonl"))
    cli_dir = tmp / "cli"
    cli_dir.mkdir()
    shutil.copy(tmp / "LightGCN-test.ckpt", cli_dir)
    flags = {k: v for k, v in cd.items()
             if k not in ("dataset", "data_path", "checkpoint_dir", "epochs")}
    r = _cli("--resume", "--epochs=3", f"--checkpoint_dir={cli_dir}",
             f"--metrics_log_path={cli_dir / 'cli.jsonl'}",
             *(f"--{k}={v}" for k, v in flags.items()))
    assert r.returncode == 0, r.stderr
    runs["cli"] = _losses(cli_dir / "cli.jsonl")
    assert int(ckpt["epoch"]) == 0
    return runs, ckpt


def test_resumed_losses_match_jax(resumed):
    runs, _ = resumed
    jl, tl = runs["jax"][2], runs["torch"][2]
    assert len(jl) == len(tl) == 2              # epochs 1 and 2
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[1] < tl[0]


def test_resumed_cli_losses_match_jax(resumed):
    runs, _ = resumed
    jl, cl = runs["jax"][2], runs["cli"]
    assert len(cl) == 2
    np.testing.assert_allclose(cl, jl, rtol=1e-4)


def test_resumed_params_match_jax(resumed):
    runs, ckpt = resumed
    jp, tp = runs["jax"][0].params, runs["torch"][0].params
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
        assert not np.array_equal(tp[k].numpy(), ckpt["params"][k])
    t_state = runs["torch"][0].opt_state
    assert int(t_state["t"]) == int(np.asarray(runs["jax"][0].opt_state["t"]))


def test_resumed_test_metrics_match_jax(resumed):
    runs, _ = resumed
    jr, tr = runs["jax"][1], runs["torch"][1]
    assert jr.keys() == tr.keys() and "recall@10" in tr
    for k in jr:
        assert abs(tr[k] - jr[k]) <= 1e-3, (k, tr[k], jr[k])


def _port_run(ckdir, epochs, saved, resume=False, **over):
    c = TConfig(config_dict=_cfg(epochs=epochs, checkpoint_dir=str(ckdir),
                                 **over))
    (tl, tr), (vl, _), (te, _) = t_data_preparation(c, t_create_dataset(c))
    trainer = TTrainer(c, t_get_model("LightGCN")(c, tr))
    trainer.fit(tl, saved=saved, verbose=False, resume=resume)
    return trainer, (tl, vl, te)


def test_resume_bit_matches_straight_run(tmp_path):
    """2 epochs + checkpoint, then a new trainer resumes for 2 more:
    the params equal a straight 4-epoch run bit for bit."""
    straight, _ = _port_run(tmp_path / "a", 4, saved=False)
    _port_run(tmp_path / "b", 2, saved=True)
    resumed, _ = _port_run(tmp_path / "b", 4, saved=False, resume=True)
    for k in straight.params:
        assert torch.equal(straight.params[k], resumed.params[k]), k
    assert int(straight.opt_state["t"]) == int(resumed.opt_state["t"])


def test_jax_reads_port_checkpoint(tmp_path):
    trainer, (tl, vl, _) = _port_run(tmp_path, 1, saved=True)
    path = trainer.saved_model_file
    jc = JConfig(config_dict=_cfg(epochs=2, checkpoint_dir=str(tmp_path)))
    with pytest.MonkeyPatch.context() as mp:
        _jax_globals(mp)
        (tl_j, tr_j), (vl_j, _), _ = j_data_preparation(jc, j_create_dataset(jc))
        jt = JTrainer(jc, j_get_model("LightGCN")(jc, tr_j))
        assert jt.resume_from_checkpoint(path) == 0
        for k in trainer.params:
            np.testing.assert_array_equal(np.asarray(jt.params[k]),
                                          trainer.params[k].numpy())
        state = jt.opt_state
        assert state["t"].dtype == np.int32
        assert int(state["t"]) == len(tl)
        jt.fit(tl_j, saved=False, verbose=False)   # trains on from epoch 1
    assert len(jt.train_timings) == 1


def test_evaluate_before_fit_raises(tmp_path):
    c = TConfig(config_dict=_cfg(checkpoint_dir=str(tmp_path / "empty")))
    _, (vl, _), _ = t_data_preparation(c, t_create_dataset(c))
    trainer = TTrainer(c, t_get_model("BPR")(c, t_create_dataset(c)))
    with pytest.raises(RuntimeError, match="before fit"):
        trainer.evaluate(vl)


def test_nan_loss_raises(tmp_path):
    with pytest.raises(ValueError, match="NaN/Inf loss at epoch 0"):
        _port_run(tmp_path, 1, saved=False, learning_rate=1e30)


def test_stopping_min_epochs_floor(tmp_path):
    """Early stopping does not fire before stopping_min_epochs even when
    the patience window is spent."""
    def run(min_ep):
        c = TConfig(config_dict=_cfg(
            epochs=12, stopping_step=1, stopping_min_epochs=min_ep,
            learning_rate=10.0, checkpoint_dir=str(tmp_path)))
        (tl, tr), (vl, _), _ = t_data_preparation(c, t_create_dataset(c))
        t = TTrainer(c, t_get_model("LightGCN")(c, tr))
        t.fit(tl, vl, saved=False, verbose=False)
        return len(t.train_timings)

    short, floored = run(0), run(8)
    assert floored >= 8, floored
    assert short < 8, short


@pytest.mark.parametrize("over", [{"mesh_shape": [2]}])
def test_unported_trainer_options_raise(over):
    c = TConfig(config_dict=_cfg(**over))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TTrainer(c, t_get_model("BPR")(c, t_create_dataset(c)))


# -- caches and the CLI ------------------------------------------------------

def test_dataset_and_split_caches_roundtrip(tmp_path):
    cd = _cfg(checkpoint_dir=str(tmp_path), save_dataset=True,
              save_dataloaders=True)
    outs = []
    for _ in range(2):        # the second pass reads both caches
        c = TConfig(config_dict=cd)
        ds = t_create_dataset(c)
        assert ds.config is c
        (tl, tr), (vl, va), (te, tt) = t_data_preparation(c, ds)
        outs.append([s.user_item_arrays() for s in (tr, va, tt)])
        assert tr.config is c
    assert sorted(os.listdir(tmp_path)) == [
        "test-GeneralGraphDataset-splits.pth", "test-GeneralGraphDataset.pth"]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "recbole_gnn_tpu_torch.run", "-m", "LightGCN",
         "-d", "test", f"--data_path={os.path.join(ROOT, 'tests', 'test_data')}",
         "--epochs=1", "--state=ERROR", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_cli_runs_on_cpu_and_needs_use_gpu_false_without_card(tmp_path):
    r = _cli("--use_gpu=False", f"--checkpoint_dir={tmp_path}")
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "LightGCN-test.ckpt").is_file()
    if torch.cuda.is_available():
        return
    r = _cli(f"--checkpoint_dir={tmp_path / 'gpu'}")
    assert r.returncode != 0 and "--use_gpu=False" in r.stderr
    r = _cli("--use_gpu=False", "--distributed")
    assert r.returncode != 0 and "ROADMAP" in r.stderr
