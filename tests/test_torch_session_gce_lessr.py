"""Port parity: GCE-GNN and LESSR.

From one JAX-initialised set of params (``params_from_numpy``) and the
fixture's padded last training batch, the ``train=False`` logits equal
the JAX package's, and so do the training loss and every gradient, with
the JAX dropout masks injected into the port (``keeps=``).  GCE-GNN at
``hop`` 1 (its yaml) and 2 with every dropout on; its global
co-occurrence table equals the JAX arrays exactly.  LESSR also on a
batch with a degenerate session (one item repeated, mailbox width
K = 19 > 8, where the JAX package scans instead of unrolling); its
calibrated BatchNorm statistics equal the JAX ``serving_calibrate``'s
site by site, and its calibrated scores of a session are the same in a
batch of 1 and of 64.  LESSR runs its yaml's four layers (EOPA, SGAT,
EOPA, SGAT), so the third layer's 3d-wide GRU and the readout and
``bn_sr`` at 5d and 6d are held too.

Tolerances: loss rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol
1e-6, the calibrated statistics rtol 1e-5 / atol 1e-6.  Logits rtol
1e-5 with atol 1e-6 times the largest |logit| (GCE-GNN's are below 1;
LESSR's reach 7 through its masked BatchNorms, and at four layers each
package's f32 logits sat up to 2.7e-6 from the same forward in f64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.data.session import build_lessr_graphs
from recbole_gnn_tpu_torch.eval.evaluator import to_device
from torch_parity_utils import (both, check_loss_and_grads, jax_globals,
                                padded_batch, port_params, seq_cfg,
                                session_keeps)

STAT_TOL = dict(rtol=1e-5, atol=1e-6)
# the yaml's four layers
LESSR = {"n_layers": 4}


def logits_match(jm, tm, jp, batch, j_extras=None, t_extras=None):
    jl = np.asarray(jm.full_scores(
        jp, jm.consts, j_extras or {},
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), False))
    with torch.no_grad():
        tl = tm.full_scores(port_params(jp, grad=False), tm.consts,
                            t_extras or {}, to_device(batch, "cpu"), None,
                            False)
    assert tl.shape == (batch["item_seq"].shape[0], tm.n_items)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5,
                               atol=1e-6 * float(np.abs(jl).max()))


def loss_and_grads_match(name, jm, tm, jp, batch):
    key = jax.random.PRNGKey(0)
    keeps = session_keeps(name, jm, batch, key)
    assert keeps, name                      # some dropout is on
    _, tg, _ = check_loss_and_grads(jm, tm, jp, batch, key, {}, {},
                                    keeps=keeps)
    assert all(bool(torch.isfinite(g).all()) for g in tg)


@pytest.mark.parametrize("over", [{}, {"hop": 2, "dropout_gcn": 0.2,
                                       "dropout_local": 0.1}],
                         ids=["hop1", "hop2-all-dropouts"])
def test_gcegnn_matches_jax(monkeypatch, over):
    jax_globals(monkeypatch)
    (_, (jtl, _, _), jm), (_, _, tm) = both(seq_cfg("GCEGNN", **over))
    for k in ("global_adj", "global_weight"):
        np.testing.assert_array_equal(tm.consts[k].numpy(),
                                      np.asarray(jm.consts[k]))
    assert int((tm.consts["global_weight"] > 0).sum()) > tm.n_items
    batch = padded_batch(jtl)
    jp = jm.init_params(jax.random.PRNGKey(3))
    logits_match(jm, tm, jp, batch)
    loss_and_grads_match("GCEGNN", jm, tm, jp, batch)


@pytest.fixture(scope="module")
def lessr():
    with pytest.MonkeyPatch.context() as mp:
        jax_globals(mp)
        (_, (jtl, _, _), jm), (_, _, tm) = both(seq_cfg("LESSR", **LESSR))
        yield jm, tm, padded_batch(jtl), jm.init_params(
            jax.random.PRNGKey(3))


def test_lessr_matches_jax(lessr):
    jm, tm, batch, jp = lessr
    logits_match(jm, tm, jp, batch)
    loss_and_grads_match("LESSR", jm, tm, jp, batch)


def test_lessr_degenerate_session_matches_the_jax_scan(lessr):
    """One session of a single repeated item: its node's in-degree is
    19, so the mailbox is 19 wide and the JAX package runs its scan."""
    jm, tm, batch, jp = lessr
    seqs = np.array(batch["item_seq"])
    lens = np.array(batch["item_seq_len"])
    L = seqs.shape[1]
    seqs[1, :] = seqs[1, 0]
    lens[1] = L
    graphs, _ = build_lessr_graphs(seqs, lens, L)
    deg = dict(batch, item_seq=seqs, item_seq_len=lens, **graphs)
    assert deg["eop_mail"].shape[2] == L - 1 > 8
    logits_match(jm, tm, jp, deg)
    loss_and_grads_match("LESSR", jm, tm, jp, deg)


def test_lessr_calibration_matches_jax_and_is_batch_invariant(lessr):
    jm, tm, batch, jp = lessr
    tp = port_params(jp, grad=False)
    j_ex = jm.serving_calibrate(jp, jm.consts, {},
                                {k: jnp.asarray(v) for k, v in batch.items()})
    t_ex = tm.serving_calibrate(tp, tm.consts, {}, to_device(batch, "cpu"))
    # per layer, the readout and bn_sr: the same sites in the same order
    assert len(t_ex["lessr_bn"]) == len(j_ex["lessr_bn"]) == \
        tm.num_layers + 2
    for (tm_, tv), (jm_, jv) in zip(t_ex["lessr_bn"], j_ex["lessr_bn"]):
        np.testing.assert_allclose(tm_.numpy(), np.asarray(jm_), **STAT_TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **STAT_TOL)
    logits_match(jm, tm, jp, batch, j_ex, t_ex)

    # one session's calibrated scores alone and among 63 others
    seqs = np.asarray(batch["item_seq"])[:64]
    lens = np.asarray(batch["item_seq_len"])[:64]

    def scores(s, n):
        graphs, _ = build_lessr_graphs(s, n, s.shape[1])
        b = to_device(dict(graphs, item_seq=s, item_seq_len=n), "cpu")
        with torch.no_grad():
            return tm.full_scores(tp, tm.consts, t_ex, b, None,
                                  False).numpy()

    alone = scores(seqs[5:6], lens[5:6])[0]
    among = scores(seqs, lens)[5]
    np.testing.assert_allclose(alone, among, rtol=1e-5,
                               atol=1e-6 * float(np.abs(among).max()))
