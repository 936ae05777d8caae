"""Port parity: SGL.

From one JAX-initialised set of params and the JAX keep masks injected
into the port's view building, the views (edge weights, and on ``ell``
the per-layer ELL slot weights) equal the JAX extras, the same edges
are dropped (the port's ``edge_inter_id`` equals the JAX map element
for element), and the loss, its parts and the gradients match, for the
augmentations ED, ND and RW on the dense graph, on ``ell`` and (ED) on
``xla``.  Then the ROADMAP gate: from one JAX checkpoint both packages
train two more epochs with the same views (the JAX draws injected) and
give the same per-epoch losses and test metrics; the views' ELL
layouts are made once per epoch, not per step; and checkpoints, with
their tuple extras, cross-load both ways.

Tolerances: views, loss and parts rtol 1e-5 / atol 1e-6; gradients rtol
1e-4 / atol 1e-6; per-epoch losses rtol 1e-4 and test metrics abs 1e-3
after the Adam steps (as ``test_torch_train.py``).
"""

import jax
import numpy as np
import pytest

from recbole_gnn_tpu.train.checkpoint import load_checkpoint as j_load
from recbole_gnn_tpu.train.trainer import Trainer as JTrainer
from recbole_gnn_tpu_torch.train.trainer import Trainer as TTrainer
from torch_parity_utils import (LOSS_TOL, assert_tree_close, both, cfg,
                                check_gate, check_loss_and_grads, jax_globals,
                                padded_batch, port_params, resumed_runs, t)


def sgl_keeps(jm, key):
    """The interaction keep masks JAX's ``_make_extras(key)`` draws: per
    view, one per repetition."""
    users, items = jm.consts["aug_users"], jm.consts["aug_items"]
    n_rep = jm.n_layers if jm.aug_type == "RW" else 1
    out = []
    for kv in jax.random.split(key):
        out.append([t(jm._keep_mask(k, users.shape[0], users, items))
                    for k in jax.random.split(kv, n_rep)])
    return out


CASES = [("ED", "dense"), ("ED", "ell"), ("ED", "xla"), ("ND", "ell"),
         ("ND", "dense"), ("RW", "ell"), ("RW", "dense")]


@pytest.mark.parametrize("aug,graph", CASES, ids=[f"{a}-{g}" for a, g in CASES])
def test_sgl_views_loss_and_grads_match_jax(monkeypatch, aug, graph):
    jax_globals(monkeypatch)
    (_, (jtl, _, _), jm), (_, _, tm) = both(cfg("SGL", graph, type=aug,
                                                drop_ratio=0.2))
    key = jax.random.PRNGKey(11)
    j_extras = jm._make_extras(key, jm.consts)
    t_extras = tm.init_extras(None, keeps=sgl_keeps(jm, key))
    # the JAX package builds ELL layouts for every sparse graph, the
    # port for an ell graph only: the views' slot weights come with them
    if graph == "ell":
        assert sorted(t_extras) == sorted(j_extras)
        assert "view1_ell_r" in t_extras
    else:
        assert sorted(t_extras) == ["view1", "view2"]
    for k in t_extras:
        assert_tree_close(t_extras[k], j_extras[k], LOSS_TOL, k)
    if graph != "dense":
        np.testing.assert_array_equal(tm.consts["edge_inter_id"].numpy(),
                                      np.asarray(jm.consts["edge_inter_id"]))
        for k in ("view1", "view2"):
            # the same edges dropped
            np.testing.assert_array_equal(t_extras[k].numpy() == 0,
                                          np.asarray(j_extras[k]) == 0)
        assert (t_extras["view1"].numpy() == 0).sum() > \
            tm.consts["graph"].n_edges_padded - tm.consts["graph"].n_edges
    batch = padded_batch(jtl)
    jp = jm.init_params(jax.random.PRNGKey(3))
    check_loss_and_grads(jm, tm, jp, batch, jax.random.PRNGKey(0), j_extras,
                         t_extras)
    tu, _ = tm.propagate(port_params(jp), tm.consts, t_extras)
    ju, _ = jm.propagate(jp, jm.consts, j_extras)
    np.testing.assert_allclose(tu.detach().numpy(), np.asarray(ju), **LOSS_TOL)


def _inject_sgl(tm, jm, seed):
    """The port model's epoch_start takes the views JAX's trainer draws
    for that epoch (``fold_in(k_train, epoch)``)."""
    k_train = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    real = tm.epoch_start

    def epoch_start(epoch, params, consts, extras, rng):
        return real(epoch, params, consts, extras, rng,
                    keeps=sgl_keeps(jm, jax.random.fold_in(k_train, epoch)))

    tm.epoch_start = epoch_start


@pytest.fixture(scope="module")
def sgl_gate(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sgl_gate")
    cd = cfg("SGL", "ell", checkpoint_dir=str(tmp), eval_step=1)
    return resumed_runs(tmp, cd, _inject_sgl), tmp


def test_sgl_two_epochs_from_a_jax_checkpoint_match_jax(sgl_gate):
    check_gate(sgl_gate[0])


def test_sgl_view_layouts_are_made_once_per_epoch(sgl_gate):
    """Two epochs of many steps each: each view's layouts (and so the
    kernel arguments their first launch makes, ``_layout_args``) are
    made once per epoch, not once per step or per launch."""
    runs, _ = sgl_gate
    _, _, _, tm, steps = runs["torch"]
    assert steps > 2
    assert tm.layout_builds == 2 * 2                # 2 views × 2 epochs
    # ED: one layout serves every layer of a view
    graphs = tm._view_graphs["view1"][1]
    assert len(graphs) == tm.n_layers and all(g is graphs[0] for g in graphs)


def test_sgl_checkpoints_cross_load(sgl_gate, tmp_path):
    """The port's SGL checkpoint (tuple extras of per-bucket slot
    weights) loads in the JAX package, and the JAX one in the port."""
    runs, tmp = sgl_gate
    from recbole_gnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                       save_checkpoint)
    ttr = runs["torch"][0]
    path = str(tmp_path / "SGL-port.ckpt")
    save_checkpoint(path, {"params": ttr.params, "extras": ttr.extras,
                           "opt_state": ttr.opt_state, "epoch": np.int64(2)})
    jstate = j_load(path)
    assert isinstance(jstate["extras"]["view1_ell"], tuple)
    assert_tree_close(ttr.extras, jstate["extras"], dict(rtol=0, atol=0))
    assert_tree_close(ttr.params, jstate["params"], dict(rtol=0, atol=0))
    jc, (tl, vl, _), jm = both(cfg("SGL", "ell", checkpoint_dir=str(tmp),
                                   epochs=4))[0]
    with pytest.MonkeyPatch.context() as mp:
        jax_globals(mp)
        jt = JTrainer(jc, jm)
        assert jt.resume_from_checkpoint(path) == 2
        jt.fit(tl, saved=False, verbose=False)     # trains on from epoch 3
    # the JAX trainer's epoch-0 checkpoint resumes in the port
    jpath = str(tmp / "SGL-test.ckpt")
    jstate = j_load(jpath)
    tc, _, tm = both(cfg("SGL", "ell", checkpoint_dir=str(tmp)))[1]
    tt = TTrainer(tc, tm)
    assert tt.resume_from_checkpoint(jpath) == 0
    assert isinstance(tt.extras["view2_ell_r"], tuple)
    assert_tree_close(tt.extras, jstate["extras"], dict(rtol=0, atol=0))
    assert_tree_close(tt.opt_state, jstate["opt_state"], dict(rtol=0, atol=0))
    assert load_checkpoint(jpath)["epoch"] == 0
