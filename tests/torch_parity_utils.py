"""Shared helpers of the model parity tests (``test_torch_general_*.py``,
``test_torch_session_*.py`` and ``test_torch_social_*.py``): both
packages' models from one config, JAX params carried into the port,
the JAX dropout draws, permutations and keep masks, and the loss /
parts / gradients comparison at the tolerances those tests state (loss
and parts rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6), and
the two-epoch gate from one JAX checkpoint.

Importing it sets torch to one intra-op thread (``OMP_NUM_THREADS``,
unless the caller set it): the tests run in several worker processes
at once, each of which collects every test file and so imports this
module, and torch's default of one thread per core in each of them
oversubscribes the host's cores on these small tensors (a test takes
several times longer than alone).  Processes the tests start inherit
the variable."""

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

from conftest import TEST_DATA, base_config_dict
from recbole_gnn_tpu.config import Config as JConfig
from recbole_gnn_tpu.models import get_model as j_get_model
from recbole_gnn_tpu.quick_start import create_dataset as j_create_dataset
from recbole_gnn_tpu.quick_start import data_preparation as j_data_preparation
from recbole_gnn_tpu.train.checkpoint import load_checkpoint as j_load
from recbole_gnn_tpu.train.trainer import Trainer as JTrainer
from recbole_gnn_tpu_torch.config import Config as TConfig
from recbole_gnn_tpu_torch.eval.evaluator import to_device
from recbole_gnn_tpu_torch.models import get_model as t_get_model
from recbole_gnn_tpu_torch.quick_start import create_dataset as t_create_dataset
from recbole_gnn_tpu_torch.quick_start import data_preparation as t_data_preparation
from recbole_gnn_tpu_torch.train.checkpoint import params_from_numpy
from recbole_gnn_tpu_torch.train.optim import tree_leaves
from recbole_gnn_tpu_torch.train.trainer import Trainer as TTrainer

os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))

j_spmm_mod = importlib.import_module("recbole_gnn_tpu.ops.spmm")
j_pallas_mod = importlib.import_module("recbole_gnn_tpu.ops.pallas_spmm")

EMB = 16
N_LAYERS = 2
GRAPHS = {"dense": {},
          "ell": {"enable_sparse": True, "sparse_spmm_impl": "ell"},
          "xla": {"enable_sparse": True, "sparse_spmm_impl": "xla"},
          "pallas": {"enable_sparse": True, "sparse_spmm_impl": "pallas"}}
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def cfg(model, graph="dense", **over):
    cd = dict(model=model, embedding_size=EMB, n_layers=N_LAYERS, seed=2020,
              use_gpu=False, **GRAPHS[graph])
    cd.update(over)
    return base_config_dict(**cd)


def seq_cfg(model, **over):
    """A session model's config on the fixture (MAX_ITEM_LIST_LENGTH 20,
    the sequential base's leave-one-out split) at narrow widths."""
    cd = dict(model=model, embedding_size=EMB, hidden_size=EMB,
              inner_size=2 * EMB, seed=2020, use_gpu=False)
    cd.update(over)
    return base_config_dict(**cd)


def jax_globals(mp):
    """The JAX package's create_dataset sets module globals: restore
    them when the context ends, so later JAX tests see the defaults."""
    mp.setattr(j_spmm_mod, "SPMM_IMPL", j_spmm_mod.SPMM_IMPL)
    mp.setattr(j_pallas_mod, "DEFAULT_PRECISION",
               j_pallas_mod.DEFAULT_PRECISION)


def both(cd, t_model_kw=None):
    """[(config, (train, valid, test) loaders, model)] for JAX, port;
    ``t_model_kw(jax_model)`` gives the port model's extra keywords."""
    out = []
    for cfg_cls, create, prep, get_model in (
            (JConfig, j_create_dataset, j_data_preparation, j_get_model),
            (TConfig, t_create_dataset, t_data_preparation, t_get_model)):
        c = cfg_cls(config_dict=cd)
        (tl, tr), (vl, _), (te, _) = prep(c, create(c))
        kw = t_model_kw(out[0][2]) if out and t_model_kw else {}
        out.append((c, (tl, vl, te), get_model(c["model"])(c, tr, **kw)))
    return out


def to_numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def port_params(jp, grad=True):
    tp = params_from_numpy(to_numpy_tree(jp), "cpu")
    if grad:
        for v in tree_leaves(tp):
            v.requires_grad_(True)
    return tp


def t(a):
    return torch.from_numpy(np.array(a))


def padded_batch(jtl):
    batch = list(jtl)[-1]                   # the padded last batch
    assert (batch["weight"] == 0).sum() > 0
    return batch


def assert_tree_close(got, want, tol=LOSS_TOL, what=""):
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   err_msg=f"{what}[{i}]", **tol)


def jax_loss_and_grads(jm, jp, batch, key, j_extras, mode=0):
    """The JAX model's (loss, parts, gradients) under ``key``."""
    def j_loss(p):
        return jm.calculate_loss(
            p, jm.consts, j_extras,
            {k: jnp.asarray(v) for k, v in batch.items()}, key, mode=mode)

    return jax.jit(jax.value_and_grad(j_loss, has_aux=True))(jp)


def port_matches(tm, jp, batch, t_extras, want, mode=0, **t_kw):
    """The port's loss, parts and gradients of every leaf (a leaf
    autograd leaves unused counts as 0, as the trainer takes it) from
    the params ``jp`` against ``want`` = ``jax_loss_and_grads(...)``."""
    (jl, jaux), jg = want
    tp = port_params(jp)
    tl, taux = tm.calculate_loss(tp, tm.consts, t_extras,
                                 to_device(batch, "cpu"), None, mode=mode,
                                 **t_kw)
    leaves = tree_leaves(tp)
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    tg = [torch.zeros_like(p) if g is None else g
          for p, g in zip(leaves, tg)]
    np.testing.assert_allclose(float(tl.detach()), float(jl), **LOSS_TOL)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   err_msg=k, **LOSS_TOL)
    assert_tree_close(tg, jg, GRAD_TOL, "grad")
    return tp, tg, jg


def check_loss_and_grads(jm, tm, jp, batch, key, j_extras, t_extras,
                         mode=0, **t_kw):
    """From one JAX param tree, the JAX loss under ``key`` against the
    port's with the JAX draws in ``t_kw``: loss, parts, gradients of
    every leaf."""
    return port_matches(tm, jp, batch, t_extras,
                        jax_loss_and_grads(jm, jp, batch, key, j_extras,
                                           mode), mode, **t_kw)


def jax_bernoulli_keeps(key, shapes, p):
    """Keep masks as a JAX forward draws them: per shape,
    rng, k = split(rng); bernoulli(k, 1 − p, shape).  ``p`` is one rate
    or one per shape."""
    ps = list(p) if isinstance(p, (list, tuple)) else [p] * len(shapes)
    out, rng = [], key
    for shape, rate in zip(shapes, ps):
        rng, k = jax.random.split(rng)
        out.append(t(jax.random.bernoulli(k, 1.0 - rate, shape)))
    return out


def session_keeps(name, jm, batch, key):
    """The dropout keep masks a JAX session model's training forward
    draws under ``key``, in its order (the port's ``keeps=``); None for
    the models without dropout.  ``batch`` may be numpy or torch."""
    B, L = batch["item_seq"].shape

    def encoder(h, heads, n_layers, p_h, p_a):
        shapes, ps = [], []
        for _ in range(n_layers):
            shapes += [(B, heads, L, L), (B, L, h), (B, L, h)]
            ps += [p_a, p_h, p_h]
        return shapes, ps

    if name == "NISER":
        return [t(jax.random.bernoulli(key, 1.0 - jm.item_dropout,
                                       (B, L, jm.embedding_size)))]
    if name == "GRU4Rec":
        return jax_bernoulli_keeps(key, [(B, L, jm.embedding_size)],
                                   jm.dropout_prob)
    if name == "NARM":
        return jax_bernoulli_keeps(
            key, [(B, L, jm.embedding_size), (B, 2 * jm.hidden_size)],
            [jm.emb_dropout, jm.ct_dropout])
    if name == "LESSR":
        d, n = jm.embedding_size, jm.num_layers
        shapes = [(B, L, d * (i + 1)) for i in range(n)]
        shapes += [(B, L, d * (n + 1)), (B, d * (n + 1) + d)]
        return (jax_bernoulli_keeps(key, shapes, jm.feat_drop)
                if jm.feat_drop > 0 else None)
    if name == "GCEGNN":
        return gcegnn_keeps(jm, B, L, key)
    if name in ("GCSAN", "SASRec"):
        shapes, ps = encoder(jm.hidden_size, jm.n_heads, jm.n_layers,
                             jm.hidden_dropout_prob, jm.attn_dropout_prob)
        if name == "SASRec":
            shapes = [(B, L, jm.hidden_size)] + shapes
            ps = [jm.hidden_dropout_prob] + ps
        return jax_bernoulli_keeps(key, shapes, ps)
    return None


def inject_session_keeps(tm, jm, seed):
    """Feed each port step the keep masks of the JAX step it mirrors."""
    k_train = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    at = {"epoch": None, "step": 0}
    real_start, real_loss = tm.epoch_start, tm.calculate_loss

    def epoch_start(epoch, params, consts, extras, rng):
        at.update(epoch=epoch, step=0)
        return real_start(epoch, params, consts, extras, rng)

    def calculate_loss(params, consts, extras, batch, rng, mode=0):
        key = jax.random.fold_in(jax.random.fold_in(k_train, at["epoch"]),
                                 at["step"])
        at["step"] += 1
        return real_loss(params, consts, extras, batch, rng, mode=mode,
                         keeps=session_keeps(type(tm).__name__, jm, batch,
                                             key))

    tm.epoch_start = epoch_start
    tm.calculate_loss = calculate_loss


def gcegnn_keeps(jm, B, L, key):
    """GCE-GNN's keep masks under ``key``, in the port's order: the
    ``dropout_gcn`` masks of the global aggregation (JAX key k1, split
    per use), then ``dropout_local``'s (k2) and ``dropout_global``'s
    (k3) (B, L, D) masks."""
    D, S = jm.embedding_size, jm.sample_num
    _, k1, k2, k3 = jax.random.split(key, 4)
    out = []
    if jm.dropout_gcn > 0:
        rng = k1
        for n_hop in range(jm.hop):
            for hop_i in range(jm.hop - n_hop):
                rng, k = jax.random.split(rng)
                out.append(t(jax.random.bernoulli(
                    k, 1.0 - jm.dropout_gcn, (B, L * S ** hop_i, 2 * D))))
    for k, p in ((k2, jm.dropout_local), (k3, jm.dropout_global)):
        if p > 0:
            out.append(t(jax.random.bernoulli(k, 1.0 - p, (B, L, D))))
    return out


def mhcn_perms(jm, key):
    """MHCN's MIM permutations under ``key``, per channel (row, second
    row, column), as the JAX ``calculate_loss`` draws them."""
    out = []
    for k in jax.random.split(key, 3):
        k1, k2, k3 = jax.random.split(k, 3)
        out.append((t(jax.random.permutation(k1, jm.n_users)),
                    t(jax.random.permutation(k2, jm.n_users)),
                    t(jax.random.permutation(k3, jm.embedding_size))))
    return out


def sept_keeps(jm, key):
    """SEPT's subgraph keep masks (interactions, net) as the JAX
    ``_build_sub_weight(key)`` draws them."""
    k1, k2 = jax.random.split(key)
    return (t(jax.random.uniform(k1, (jm._n_inter,)) >= jm.drop_ratio),
            t(jax.random.uniform(k2, (jm._n_net,)) >= jm.drop_ratio))


def review_data(tmp_path, dim=8):
    """The fixture plus .user/.item files with float_seq review columns
    (as the JAX package's DiffNet review test writes them); a few users
    and items have none, so their rows stay zero."""
    d = tmp_path / "test"
    d.mkdir()
    for suffix in ("inter", "net"):
        shutil.copy(os.path.join(TEST_DATA, "test", f"test.{suffix}"),
                    d / f"test.{suffix}")
    rng = np.random.default_rng(0)
    lines = open(d / "test.inter").read().splitlines()[1:]
    users = sorted({line.split("\t")[0] for line in lines})[3:]
    items = sorted({line.split("\t")[1] for line in lines})[5:]
    for name, ids in (("user", users), ("item", items)):
        with open(d / f"test.{name}", "w") as f:
            f.write(f"{name}_id:token\t{name}_review_emb:float_seq\n")
            for i in ids:
                f.write(i + "\t" + " ".join(
                    f"{v:.4f}" for v in rng.normal(size=dim)) + "\n")
    return {"data_path": str(tmp_path), "load_col": {
        "inter": ["user_id", "item_id", "rating", "timestamp"],
        "net": ["source_id", "target_id"],
        "user": ["user_id", "user_review_emb"],
        "item": ["item_id", "item_review_emb"]}}


def session_cli(model, tmp_path, *extra):
    """``python -m recbole_gnn_tpu_torch.run`` of a session model on the
    fixture for one epoch at narrow widths (the session CLI tests)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return subprocess.run(
        [sys.executable, "-m", "recbole_gnn_tpu_torch.run", "-m", model,
         "-d", "test",
         f"--data_path={os.path.join(root, 'tests', 'test_data')}",
         "--epochs=1", "--embedding_size=16", "--hidden_size=16",
         "--inner_size=32", "--MAX_ITEM_LIST_LENGTH=20",
         f"--checkpoint_dir={tmp_path}", *extra],
        cwd=root, capture_output=True, text=True, timeout=300)


def check_session_cli(model, tmp_path, *extra):
    """One CLI epoch on the CPU: exit 0, a finite loss and validation,
    the test result logged, a checkpoint written."""
    log = tmp_path / "log.jsonl"
    r = session_cli(model, tmp_path, "--use_gpu=False",
                    f"--metrics_log_path={log}", *extra)
    assert r.returncode == 0, r.stderr[-3000:]
    events = [json.loads(line) for line in open(log)]
    losses = [e["loss"] for e in events if e["event"] == "train_epoch"]
    assert len(losses) == 1 and np.isfinite(losses[0])
    valid = [e for e in events if e["event"] == "valid"]
    assert valid and np.isfinite(valid[0]["recall@10"])
    assert "test result" in r.stdout + r.stderr
    assert (tmp_path / f"{model}-test.ckpt").is_file()


def _losses(path):
    with open(path) as f:
        return [r["loss"] for r in map(json.loads, f)
                if r["event"] == "train_epoch"]


def resumed_runs(tmp, cd, inject):
    """A JAX trainer runs epoch 0 and saves; both packages resume from
    that checkpoint and train epochs 1 and 2 with the same draws."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_globals(mp)
        (jc, (tl, vl, _), jm), _ = both(dict(cd, epochs=1))
        JTrainer(jc, jm).fit(tl, vl, saved=True, verbose=False)
        ckpt = j_load(str(tmp / f"{cd['model']}-test.ckpt"))
        (jc, jl, jm), (tc, tl_, tm) = both(dict(cd, epochs=3))
        inject(tm, jm, cd["seed"])
        for name, c, (tl, vl, te), m, cls in (
                ("jax", jc, jl, jm, JTrainer), ("torch", tc, tl_, tm,
                                                TTrainer)):
            c["metrics_log_path"] = str(tmp / f"{name}.jsonl")
            tr = cls(c, m)
            tr.fit(tl, vl, saved=False, verbose=False, resume=True)
            runs[name] = (tr, tr.evaluate(te, load_best_model=False),
                          _losses(tmp / f"{name}.jsonl"), m, len(tl))
    assert int(ckpt["epoch"]) == 0
    return runs


def check_gate(runs, loss_rtol=1e-4, metric_atol=1e-3):
    """The ROADMAP gate: the same per-epoch losses (``loss_rtol``) and
    test metrics (``metric_atol``) from the two packages' resumed
    runs."""
    (_, jr, jl, _, _), (_, tr, tl, _, _) = runs["jax"], runs["torch"]
    assert len(jl) == len(tl) == 2              # epochs 1 and 2
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol)
    assert jr.keys() == tr.keys() and "recall@10" in tr
    for k in jr:
        assert abs(tr[k] - jr[k]) <= metric_atol, (k, tr[k], jr[k])


__all__ = ["EMB", "N_LAYERS", "GRAPHS", "LOSS_TOL", "GRAD_TOL", "cfg",
           "seq_cfg", "session_keeps", "session_cli", "check_session_cli",
           "jax_globals", "both", "port_params", "t", "padded_batch",
           "assert_tree_close", "check_loss_and_grads",
           "jax_loss_and_grads", "port_matches",
           "jax_bernoulli_keeps", "to_numpy_tree", "resumed_runs",
           "check_gate", "inject_session_keeps", "gcegnn_keeps",
           "mhcn_perms", "sept_keeps", "review_data"]
