"""Port parity: DirectAU (MF and LightGCN encoders), NeuMF, SSL4REC and
the case-study helpers.

From one JAX-initialised set of params, with the JAX dropout masks
injected where the model draws any, the loss, its parts and the
gradients match; NeuMF's full-sort scores (every pair through the MLP,
over item chunks) equal the JAX ``score_users_vs_all`` whatever the
chunking; DirectAU's ``weight_decay: 1e-6`` reaches the
trainer's optimizer; ``full_sort_scores`` / ``full_sort_topk`` /
``topk_items_by_token`` give the JAX results for the same params and
history (``tests/test_case_study.py``'s cases).

Tolerances: loss and parts rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 /
atol 1e-6, scores rtol 1e-5 / atol 1e-6; top-k item ids equal.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.ops.topk import NEG_INF as J_NEG_INF
from recbole_gnn_tpu.utils import case_study as j_cs
from recbole_gnn_tpu_torch.ops.topk import NEG_INF
from recbole_gnn_tpu_torch.quick_start import create_dataset as t_create_dataset
from recbole_gnn_tpu_torch.quick_start import data_preparation as t_data_preparation
from recbole_gnn_tpu_torch.train.trainer import Trainer as TTrainer
from recbole_gnn_tpu_torch.utils import case_study as t_cs
from torch_parity_utils import (LOSS_TOL, both, cfg, check_loss_and_grads,
                                jax_bernoulli_keeps, jax_globals,
                                padded_batch, port_params, t)

t_neumf_mod = importlib.import_module(
    "recbole_gnn_tpu_torch.models.general.neumf")

DIRECTAU = [("MF", "dense"), ("LightGCN", "dense"), ("LightGCN", "ell")]


@pytest.mark.parametrize("encoder,graph", DIRECTAU,
                         ids=[f"{e}-{g}" for e, g in DIRECTAU])
def test_directau_loss_and_grads_match_jax(monkeypatch, encoder, graph):
    jax_globals(monkeypatch)
    (jc, (jtl, _, _), jm), (tc, _, tm) = both(cfg("DirectAU", graph,
                                                  encoder=encoder))
    jp = jm.init_params(jax.random.PRNGKey(3))
    check_loss_and_grads(jm, tm, jp, padded_batch(jtl), jax.random.PRNGKey(0),
                         {}, {})
    tu, ti = tm.propagate(port_params(jp), tm.consts, {})
    ju, ji = jm.propagate(jp, jm.consts, {})
    np.testing.assert_allclose(tu.detach().numpy(), np.asarray(ju), **LOSS_TOL)
    np.testing.assert_allclose(ti.detach().numpy(), np.asarray(ji), **LOSS_TOL)
    # the config's weight decay reaches the optimizer: zero gradients
    # still move the params, by lr·g/(|g| + 1e-8) with g = wd·p on
    # Adam's first step
    assert tc["weight_decay"] == jc["weight_decay"] == 1e-6
    tr = TTrainer(tc, tm)
    p = port_params(jp, grad=False)
    before = p["user_emb"].clone()
    tr.optimizer.update({k: torch.zeros_like(v) for k, v in p.items()},
                        tr.optimizer.init(p), p)
    lr, g = float(tc["learning_rate"]), 1e-6 * before.numpy()
    np.testing.assert_allclose((before - p["user_emb"]).numpy(),
                               lr * g / (np.abs(g) + 1e-8), rtol=1e-3,
                               atol=1e-9)


def neumf_draws(jm, key, b):
    """Per scored side (pos, neg) the MLP dropout masks JAX draws."""
    dims = [2 * jm.mlp_size] + jm.mlp_hidden
    return tuple(jax_bernoulli_keeps(k, [(b, d) for d in dims[:-1]],
                                     jm.dropout_prob)
                 for k in jax.random.split(key))


def test_neumf_loss_grads_and_full_sort_scores_match_jax(monkeypatch):
    jax_globals(monkeypatch)
    (_, (jtl, _, _), jm), (_, _, tm) = both(cfg("NeuMF"))
    assert not tm.factorized_eval
    batch = padded_batch(jtl)
    jp = jm.init_params(jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(7)
    check_loss_and_grads(jm, tm, jp, batch, key, {}, {},
                         draws=neumf_draws(jm, key, len(batch["user_id"])))
    users = np.array([1, 2, 5, 9], np.int64)
    want = np.asarray(jm.score_users_vs_all(jp, jnp.asarray(users)))
    tp = port_params(jp, grad=False)
    with torch.no_grad():
        got = tm.score_users_vs_all(tp, torch.from_numpy(users))
        # a budget of a few items per chunk: the same scores
        monkeypatch.setattr(t_neumf_mod, "SCORE_BYTES_BUDGET",
                            4 * 128 * 4 * 7)
        small = tm.score_users_vs_all(tp, torch.from_numpy(users))
    assert got.shape == (4, tm.n_items)
    np.testing.assert_allclose(got.numpy(), want, **LOSS_TOL)
    np.testing.assert_allclose(small.numpy(), want, **LOSS_TOL)


def test_ssl4rec_loss_and_grads_match_jax(monkeypatch):
    jax_globals(monkeypatch)
    (_, (jtl, _, _), jm), (_, _, tm) = both(cfg("SSL4REC"))
    batch = padded_batch(jtl)
    jp = jm.init_params(jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(7)
    shape = (len(batch["item_id"]), jm.emb_size)
    draws = tuple(t(jax.random.bernoulli(k, 1.0 - jm.drop_ratio, shape))
                  for k in jax.random.split(key))
    check_loss_and_grads(jm, tm, jp, batch, key, {}, {}, draws=draws)
    tu, ti = tm.propagate(port_params(jp), tm.consts, {})
    ju, ji = jm.propagate(jp, jm.consts, {})
    np.testing.assert_allclose(tu.detach().numpy(), np.asarray(ju), **LOSS_TOL)
    np.testing.assert_allclose(ti.detach().numpy(), np.asarray(ji), **LOSS_TOL)


# -- case study (tests/test_case_study.py's cases) ------------------------

@pytest.mark.parametrize("model", ["LightGCN", "NeuMF"])
def test_case_study_matches_jax(monkeypatch, model):
    jax_globals(monkeypatch)
    (_, _, jm), (tc, _, tm) = both(cfg(model))
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = port_params(jp, grad=False)
    (_, train_ds), _, _ = t_data_preparation(tc, t_create_dataset(tc))
    history = train_ds.history_matrix()
    uids = [u for u in (1, 2, 3) if len(history.get(u, ())) > 0]
    got = t_cs.full_sort_scores(uids, tm, tp, {}, history=history)
    want = np.asarray(j_cs.full_sort_scores(uids, jm, jp, {},
                                            history=history))
    assert NEG_INF == J_NEG_INF
    assert got.shape == (len(uids), tm.n_items)
    np.testing.assert_allclose(got.numpy(), want, **LOSS_TOL)
    assert (got[:, 0] <= NEG_INF).all()
    for b, u in enumerate(uids):
        assert (got[b, history[u]] <= NEG_INF).all()
    sc, idx = t_cs.full_sort_topk(np.array(uids), tm, tp, {}, 5,
                                  history=history)
    jsc, jidx = j_cs.full_sort_topk(np.array(uids), jm, jp, {}, 5,
                                    history=history)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), **LOSS_TOL)
    for b, u in enumerate(uids):
        assert 0 not in idx[b].tolist()
        assert not set(idx[b].tolist()) & set(history.get(int(u), ()))
    if model == "LightGCN":
        i2t = train_ds.field2id_token[train_ds.uid_field]
        toks = [str(i2t[1]), str(i2t[2])]
        recs = t_cs.topk_items_by_token(toks, tm, tp, {}, train_ds, 4)
        jrecs = j_cs.topk_items_by_token(toks, jm, jp, {}, train_ds, 4)
        assert recs == jrecs and all(len(v) == 4 for v in recs.values())
    # without a history only PAD is masked
    open_ = t_cs.full_sort_scores(uids[:1], tm, tp, {})
    assert torch.isfinite(open_[0, 1:]).all() and open_[0, 0] <= NEG_INF


def test_tests_run_torch_on_one_thread():
    """The shared helper's thread count holds in the test process: at
    torch's default of one thread per core, the test workers
    oversubscribe the host's cores."""
    assert os.environ["OMP_NUM_THREADS"] == "1"
    assert torch.get_num_threads() == 1
