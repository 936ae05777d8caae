"""Port parity: NCL and HMLET, in both loss modes.

NCL: the E-step's k-means from the JAX starting rows gives the JAX
centroids (within 1e-5) and the same assignments; the loss, its parts
and the gradients match without ProtoNCE (mode 0) and with it (mode 1)
on the dense graph and on ``ell``; and the ROADMAP gate: from one JAX
checkpoint two more epochs, the E-step in each, give the same losses
and test metrics (``warm_up_step: 0``, so ProtoNCE runs).

HMLET: with the JAX dropout masks and Gumbel uniforms injected, the
loss, parts and gradients match with the gates frozen (mode 0, their
gradients 0) and trained (mode 1); one Adam step from both gives the
same params and optimizer state, the frozen gates included; the hard
evaluation forward matches; the temperature schedule and loss modes
follow the JAX ones; and a checkpoint with the nested ``gates`` lists
cross-loads both ways.

Tolerances: loss and parts rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 /
atol 1e-6; after one Adam step m as the gradients, v (the squares)
rtol 2e-4, the params rtol 1e-5 / atol 1e-5 = lr·1e-3 (the first step
moves a param by lr·g/(|g| + ε), which a gradient entry within its atol
of 0 can move anywhere in ±lr, so the atol covers the ~1e-3 of the
ratio left by gradients that cancel toward 0) — for the embeddings:
a gate's linear bias before a BatchNorm has a true gradient of 0, its
computed one is rounding noise, which Adam's first step turns into
±lr; per-epoch losses rtol 1e-4 and test metrics abs 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.train.checkpoint import load_checkpoint as j_load
from recbole_gnn_tpu.train.checkpoint import save_checkpoint as j_save
from recbole_gnn_tpu.train.optim import make_optimizer as j_make_optimizer
from recbole_gnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   params_from_numpy,
                                                   save_checkpoint)
from recbole_gnn_tpu_torch.train.optim import make_optimizer as t_make_optimizer
from recbole_gnn_tpu_torch.train.optim import tree_leaves, tree_unflatten
from torch_parity_utils import (GRAD_TOL, LOSS_TOL, assert_tree_close, both, cfg,
                                check_gate, check_loss_and_grads, jax_globals,
                                padded_batch, port_params, resumed_runs, t,
                                to_numpy_tree)

K = 10


def ncl_init_idx(jm, key):
    """The k-means starting rows JAX's E-step draws under ``key``."""
    ku, ki = jax.random.split(key)
    return (t(jax.random.choice(ku, jm.n_users, (jm.k,), replace=False)),
            t(jax.random.choice(ki, jm.n_items, (jm.k,), replace=False)))


def _ncl_extras(jm, tm, jp, key):
    j_extras = jm.epoch_start(0, jp, jm.consts, jm.init_extras(key), key)
    t_extras = tm.epoch_start(0, port_params(jp), tm.consts, {}, None,
                              init_idx=ncl_init_idx(jm, key))
    assert sorted(t_extras) == sorted(j_extras)
    for side in ("user", "item"):
        np.testing.assert_allclose(t_extras[f"{side}_centroids"].numpy(),
                                   np.asarray(j_extras[f"{side}_centroids"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(t_extras[f"{side}_2cluster"].numpy(),
                                      np.asarray(j_extras[f"{side}_2cluster"]))
        assert t_extras[f"{side}_2cluster"].dtype == torch.int32
    return j_extras, t_extras


@pytest.mark.parametrize("graph", ["dense", "ell"])
@pytest.mark.parametrize("mode", [0, 1])
def test_ncl_loss_and_grads_match_jax(monkeypatch, graph, mode):
    jax_globals(monkeypatch)
    (_, (jtl, _, _), jm), (_, _, tm) = both(cfg("NCL", graph,
                                                num_clusters=K))
    jp = jm.init_params(jax.random.PRNGKey(3))
    j_extras, t_extras = _ncl_extras(jm, tm, jp, jax.random.PRNGKey(9))
    check_loss_and_grads(jm, tm, jp, padded_batch(jtl), jax.random.PRNGKey(0),
                         j_extras, t_extras, mode=mode)
    assert [tm.loss_mode(e) for e in (0, 19, 20)] == \
        [jm.loss_mode(e) for e in (0, 19, 20)] == [0, 0, 1]


def _inject_ncl(tm, jm, seed):
    k_train = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    real = tm.epoch_start

    def epoch_start(epoch, params, consts, extras, rng):
        return real(epoch, params, consts, extras, rng, init_idx=ncl_init_idx(
            jm, jax.random.fold_in(k_train, epoch)))

    tm.epoch_start = epoch_start


def test_ncl_two_epochs_from_a_jax_checkpoint_match_jax(tmp_path):
    cd = cfg("NCL", "ell", checkpoint_dir=str(tmp_path), num_clusters=K,
             warm_up_step=0, eval_step=1)
    runs = resumed_runs(tmp_path, cd, _inject_ncl)
    check_gate(runs)
    # the last E-step's prototypes
    jx, tx = runs["jax"][0].extras, runs["torch"][0].extras
    np.testing.assert_array_equal(tx["user_2cluster"].numpy(),
                                  np.asarray(jx["user_2cluster"]))


# -- HMLET -----------------------------------------------------------------

def hmlet_draws(jm, key, n, train):
    """Per gate the draws of one JAX HMLET forward under ``key``: the
    dropout mask of each BatchNorm layer (training only) and the Gumbel
    uniforms."""
    rng, out = key, []
    for _ in jm.gate_layer_ids:
        rng, k = jax.random.split(rng)
        drops = []
        for d in jm.gating_mlp_dims[:-1]:
            if train and jm.dropout_ratio > 0:
                k, kk = jax.random.split(k)
                drops.append(t(jax.random.bernoulli(
                    kk, 1.0 - jm.dropout_ratio, (n, d))))
        k, k2 = jax.random.split(k)
        out.append({"drop": drops, "u": t(jax.random.uniform(k2, (n, 2)))})
    return out


def _hmlet_cfg(graph, **over):
    return cfg("HMLET", graph, n_layers=3, gate_layer_ids=[1, 2], **over)


@pytest.mark.parametrize("graph", ["dense", "ell"])
@pytest.mark.parametrize("mode", [0, 1])
def test_hmlet_loss_grads_and_adam_match_jax(monkeypatch, graph, mode):
    jax_globals(monkeypatch)
    (_, (jtl, _, _), jm), (_, _, tm) = both(_hmlet_cfg(graph))
    jp = jm.init_params(jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(5)
    # a temperature off its initial value
    j_extras = {"gum_temp": jnp.asarray(0.5)}
    t_extras = {"gum_temp": torch.tensor(0.5)}
    n = jm.n_users + jm.n_items
    tp, tg, jg = check_loss_and_grads(
        jm, tm, jp, padded_batch(jtl), key, j_extras, t_extras, mode=mode,
        draws=hmlet_draws(jm, key, n, True))
    gate_grads = tree_leaves(tree_unflatten(tp, tg)["gates"])
    assert all(bool((g == 0).all()) for g in gate_grads) == (mode == 0)
    # one Adam step from both: params and state equal, frozen gates too
    jopt, topt = j_make_optimizer(lr=0.01), t_make_optimizer(lr=0.01)
    js = jopt.init(jp)
    jp2, js = jopt.update(jg, js, jp)
    tparams = port_params(jp, grad=False)
    ts = topt.init(tparams)
    topt.update(tree_unflatten(tparams, tg), ts, tparams)
    assert_tree_close(ts["m"], js["m"], GRAD_TOL, "m")
    assert_tree_close(ts["v"], js["v"], dict(rtol=2e-4, atol=1e-12), "v")
    for k in ("user_emb", "item_emb"):
        assert_tree_close(tparams[k], jp2[k], dict(rtol=1e-5, atol=1e-5), k)
    if mode == 0:
        assert_tree_close(tparams["gates"], jp["gates"], dict(rtol=0, atol=0))
        assert_tree_close(jp2["gates"], jp["gates"], dict(rtol=0, atol=0))
    # the hard evaluation forward under its fixed key
    tu, ti = tm.propagate(port_params(jp), tm.consts, t_extras,
                          draws=hmlet_draws(jm, jax.random.PRNGKey(0), n,
                                            False))
    ju, ji = jm.propagate(jp, jm.consts, j_extras)
    np.testing.assert_allclose(tu.detach().numpy(), np.asarray(ju), **LOSS_TOL)
    np.testing.assert_allclose(ti.detach().numpy(), np.asarray(ji), **LOSS_TOL)


def test_hmlet_temperature_and_modes_follow_jax(monkeypatch):
    jax_globals(monkeypatch)
    (_, _, jm), (_, _, tm) = both(_hmlet_cfg("dense", warm_up_epochs=3))
    je, te = jm.init_extras(None), tm.init_extras(None)
    for epoch in range(12):
        je = jm.epoch_start(epoch, None, None, je, None)
        te = tm.epoch_start(epoch, None, None, te, None)
        np.testing.assert_allclose(float(te["gum_temp"]),
                                   float(je["gum_temp"]), rtol=1e-6)
        assert tm.loss_mode(epoch) == jm.loss_mode(epoch)
    assert float(te["gum_temp"]) < tm.ori_temp
    assert [tm.loss_mode(e) for e in (3, 4)] == [0, 1]


def test_hmlet_checkpoints_cross_load(monkeypatch, tmp_path):
    """Nested ``gates`` lists of dicts and a 0-d extra, both ways."""
    jax_globals(monkeypatch)
    (_, _, jm), (_, _, tm) = both(_hmlet_cfg("dense"))
    tp = tm.init_params(torch.Generator().manual_seed(0))
    te = tm.init_extras(None)
    opt = t_make_optimizer().init(tp)
    path = str(tmp_path / "port.ckpt")
    save_checkpoint(path, {"params": tp, "extras": te, "opt_state": opt})
    js = j_load(path)
    assert isinstance(js["params"]["gates"], list)
    assert isinstance(js["params"]["gates"][0], list)
    assert_tree_close(tp, js["params"], dict(rtol=0, atol=0))
    assert float(js["extras"]["gum_temp"]) == pytest.approx(tm.ori_temp)
    jp = jm.init_params(jax.random.PRNGKey(1))
    path = str(tmp_path / "jax.ckpt")
    j_save(path, {"params": jp, "extras": jm.init_extras(None),
                  "opt_state": j_make_optimizer().init(jp)})
    st = load_checkpoint(path)
    tp2 = params_from_numpy(st["params"], "cpu")
    assert_tree_close(tp2, to_numpy_tree(jp), dict(rtol=0, atol=0))
    opt2 = params_from_numpy(st["opt_state"], "cpu")
    assert len(tree_leaves(opt2["m"])) == len(tree_leaves(tp2))
    ex = params_from_numpy(st["extras"], "cpu")
    assert ex["gum_temp"].dim() == 0
