"""Port parity: SEPT.

With the JAX subgraph keep masks injected (``keeps=``), the port's
per-epoch extras equal the JAX ones (the re-weighted subgraph's edge
weights and, on ``ell``, its ELL slot weights), and the loss, its parts
and every gradient equal the JAX model's in mode 0 (warm-up: the rec
loss only) and mode 1 (tri-training), on the dense views and with
``enable_sparse: True`` on each of ``ell``, ``pallas`` and ``xla``, on a
padded batch with more valid rows than ``instance_cnt``.  The JAX side
is compiled once (dense views, its subgraph on the segment sum).  Then the
gate past warm-up (``warm_up_epochs: 0``): from one JAX checkpoint both
packages train two more epochs with the JAX keep masks of each epoch
and give the same per-epoch losses (rtol 1e-5) and test metrics
(|Δ| ≤ 1e-4), on the dense views with the subgraph on ``ell``; the
subgraph's layouts are made once per epoch, not per step.

Tolerances: extras, loss and parts rtol 1e-5 / atol 1e-6; gradients
rtol 1e-4 / atol 1e-6.
"""

import jax
import numpy as np
import pytest

from torch_parity_utils import (GRAPHS, LOSS_TOL, assert_tree_close, both,
                                cfg, check_gate, jax_globals,
                                jax_loss_and_grads, padded_batch,
                                port_matches, resumed_runs, sept_keeps)


@pytest.fixture(scope="module")
def reference():
    """The JAX model's extras, and its loss, parts and gradients in both
    modes, once: dense views, and the subgraph on the segment sum
    (``xla``), whose compile is the cheapest."""
    with pytest.MonkeyPatch.context() as mp:
        jax_globals(mp)
        (_, (jtl, _, _), jm), _ = both(cfg("SEPT", "dense",
                                           sparse_spmm_impl="xla"))
        key = jax.random.PRNGKey(5)
        j_extras = jm._make_extras(key, jm.consts)
        batch = padded_batch(jtl)
        jp = jm.init_params(jax.random.PRNGKey(3))
        want = [jax_loss_and_grads(jm, jp, batch, jax.random.PRNGKey(0),
                                   j_extras, mode) for mode in (0, 1)]
        return sept_keeps(jm, key), j_extras, batch, jp, want


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_sept_extras_loss_and_grads_match_jax(monkeypatch, reference,
                                              graph):
    jax_globals(monkeypatch)
    keeps, j_extras, batch, jp, want = reference
    _, (_, _, tm) = both(cfg("SEPT", graph))
    t_extras = tm.init_extras(None, keeps=keeps)
    # the JAX package builds ELL layouts for every sparse graph, the
    # port for an ell graph only: the slot weights come with them
    sub_ell = tm.consts["sub_graph"].impl == "ell"
    assert sorted(t_extras) == (sorted(j_extras) if sub_ell
                                else ["sub_weight"])
    for k in t_extras:
        assert_tree_close(t_extras[k], j_extras[k], LOSS_TOL, k)
    dropped = int((t_extras["sub_weight"] == 0).sum())
    assert 0 < dropped < t_extras["sub_weight"].numel()
    assert int((batch["weight"] > 0).sum()) > tm.instance_cnt
    for mode in (0, 1):
        port_matches(tm, jp, batch, t_extras, want[mode], mode=mode)
    # warm-up: mode 0 and the extras left as they are
    assert tm.loss_mode(tm.warm_up_epochs - 1) == 0
    assert tm.loss_mode(tm.warm_up_epochs) == 1
    assert tm.epoch_start(0, None, tm.consts, t_extras, None) is t_extras


def _inject_sept(tm, jm, seed):
    """Each epoch's subgraph from the keep masks JAX's trainer draws
    for that epoch (``fold_in(k_train, epoch)``)."""
    k_train = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    real = tm.epoch_start

    def epoch_start(epoch, params, consts, extras, rng):
        return real(epoch, params, consts, extras, rng,
                    keeps=sept_keeps(jm, jax.random.fold_in(k_train, epoch)))

    tm.epoch_start = epoch_start


def test_sept_two_epochs_past_warm_up_match_jax(tmp_path):
    # dense views and joint graph; the subgraph stays sparse on ell
    cd = cfg("SEPT", "dense", checkpoint_dir=str(tmp_path), eval_step=1,
             warm_up_epochs=0, ssl_weight=1e-3)
    runs = resumed_runs(tmp_path, cd, _inject_sept)
    check_gate(runs, loss_rtol=1e-5, metric_atol=1e-4)
    _, _, _, tm, steps = runs["torch"]
    assert steps > 2
    assert tm.layout_builds == 2                     # once per epoch
    got, want = runs["torch"][0].extras, runs["jax"][0].extras
    assert sorted(got) == sorted(want)
    for k in got:
        assert_tree_close(got[k], want[k], LOSS_TOL, k)
    assert np.isfinite(runs["torch"][2]).all()
