"""Port parity: the general family's ops and losses against their JAX
counterparts — K6's graph ops (``degree``, ``sym_norm_weights``,
``row_norm_weights``, the two dropout masks' laws), k-means from
injected starting rows, ``info_nce`` in both branches (the chunked
logsumexp forced with a small ``_NCE_CHUNK_ENTRIES``),
``batch_softmax_loss``, ``alignment_loss``, ``uniformity_loss``,
``l2_normalize`` at a zero row, and the optimizer's tree functions and
``params_from_numpy`` on nested lists.

Tolerances: values rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol
1e-6; degrees exact (sums of 0/1); k-means centroids 1e-5 and equal
assignments.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.models import losses as j_losses
from recbole_gnn_tpu.models.init import l2_normalize as j_l2_normalize
from recbole_gnn_tpu.ops import graphops as j_graphops
from recbole_gnn_tpu.ops.kmeans import kmeans as j_kmeans
from recbole_gnn_tpu_torch.models import losses
from recbole_gnn_tpu_torch.models.init import l2_normalize
from recbole_gnn_tpu_torch.ops import graphops
from recbole_gnn_tpu_torch.ops.kmeans import kmeans
from recbole_gnn_tpu_torch.train.checkpoint import params_from_numpy
from recbole_gnn_tpu_torch.train.optim import (make_optimizer, tree_leaves,
                                               tree_map, tree_unflatten)
from torch_parity_utils import GRAD_TOL, LOSS_TOL, t

t_losses_mod = importlib.import_module("recbole_gnn_tpu_torch.models.losses")


def _edges(rng, n=50, e=400):
    return (rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32), n)


@pytest.mark.parametrize("masked", [False, True])
def test_graph_norms_match_jax(masked):
    rng = np.random.default_rng(0)
    src, dst, n = _edges(rng)
    mask = rng.random(len(src)) > 0.3 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    w = rng.random(len(src)).astype(np.float32)
    np.testing.assert_array_equal(
        graphops.degree(td, n).numpy(),
        np.asarray(j_graphops.degree(jnp.asarray(dst), n)))
    np.testing.assert_allclose(
        graphops.degree(td, n, torch.from_numpy(w)).numpy(),
        np.asarray(j_graphops.degree(jnp.asarray(dst), n, jnp.asarray(w))),
        **LOSS_TOL)
    for fn in ("sym_norm_weights", "row_norm_weights"):
        got = getattr(graphops, fn)(ts, td, n, mask=tm)
        want = getattr(j_graphops, fn)(jnp.asarray(src), jnp.asarray(dst), n,
                                       mask=jm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)
        if masked:
            assert not got.numpy()[~mask].any()


def test_dropout_masks_laws():
    """The generator draws differ from JAX's; the laws are the same:
    keep probability 1 − p per edge, and node dropout keeps an edge
    only when both its ends are kept."""
    gen = torch.Generator().manual_seed(0)
    keep = graphops.edge_dropout_mask(gen, 200_000, 0.3)
    assert keep.dtype == torch.bool
    assert abs(float(keep.float().mean()) - 0.7) < 0.01
    rng = np.random.default_rng(1)
    src, dst, n = _edges(rng, 100_000, 50_000)
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    gen = torch.Generator().manual_seed(2)
    em = graphops.node_dropout_edge_mask(gen, ts, td, n, 0.3)
    kept = torch.rand(n, generator=torch.Generator().manual_seed(2)) >= 0.3
    assert torch.equal(em, kept[ts.long()] & kept[td.long()])
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    # JAX's node mask keeps ~0.7² of the edges too
    jkeep = j_graphops.node_dropout_edge_mask(
        jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(dst), n, 0.3)
    for m in (float(em.float().mean()), float(jnp.mean(jkeep))):
        assert abs(m - 0.49) < 0.01


def test_kmeans_matches_jax_from_the_same_start():
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(6, 8)) * 4
    x = (centers[rng.integers(0, 6, 300)]
         + rng.normal(size=(300, 8))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jc, ja = j_kmeans(key, jnp.asarray(x), 6)
    init = t(jax.random.choice(key, 300, (6,), replace=False))
    tc, ta = kmeans(None, torch.from_numpy(x), 6, init_idx=init)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    # from a generator: k distinct rows of x to start from
    gc, _ = kmeans(torch.Generator().manual_seed(0), torch.from_numpy(x), 6,
                   n_iter=0)
    rows = {tuple(r) for r in x.tolist()}
    assert len({tuple(r) for r in gc.tolist()} & rows) == 6


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_info_nce_matches_jax(monkeypatch, chunked, reduction):
    rng = np.random.default_rng(4)
    b, n, d = 8, 2600, 6
    v1, v2 = (rng.normal(size=(b, d)).astype(np.float32) for _ in range(2))
    av2 = rng.normal(size=(n, d)).astype(np.float32)
    w = np.ones(b, np.float32)
    w[-2:] = 0.0
    if chunked:   # 3 chunks of 1,024 rows (the minimum chunk)
        monkeypatch.setattr(j_losses, "_NCE_CHUNK_ENTRIES", 1)
        monkeypatch.setattr(t_losses_mod, "_NCE_CHUNK_ENTRIES", 1)
    calls = []
    real = t_losses_mod._chunked_lse
    monkeypatch.setattr(t_losses_mod, "_chunked_lse",
                        lambda *a: calls.append(1) or real(*a))
    tt = [torch.from_numpy(a).requires_grad_() for a in (v1, v2, av2)]
    got = losses.info_nce(*tt[:2], 0.2, weight=torch.from_numpy(w),
                          all_view2=tt[2], reduction=reduction)
    got.backward()
    want, grads = jax.value_and_grad(
        lambda a, b_, c: j_losses.info_nce(a, b_, 0.2, weight=jnp.asarray(w),
                                           all_view2=c, reduction=reduction),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (v1, v2, av2)))
    assert bool(calls) == chunked
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS_TOL)
    for a, g in zip(tt, grads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), **GRAD_TOL)


def test_small_losses_match_jax():
    rng = np.random.default_rng(6)
    b, d = 12, 5
    u, i = (rng.normal(size=(b, d)).astype(np.float32) for _ in range(2))
    w = np.ones(b, np.float32)
    w[-3:] = 0.0
    cases = [
        ("batch_softmax_loss", lambda L, a, c, ww: L.batch_softmax_loss(
            a, c, 0.1, ww)),
        ("alignment_loss", lambda L, a, c, ww: L.alignment_loss(a, c, ww)),
        ("uniformity_loss", lambda L, a, c, ww: L.uniformity_loss(a, ww)
         + L.uniformity_loss(c)),
        ("reg_loss_l2", lambda L, a, c, ww: L.reg_loss_l2([a, c])),
    ]
    for name, f in cases:
        tt = [torch.from_numpy(a).requires_grad_() for a in (u, i)]
        got = f(losses, *tt, torch.from_numpy(w))
        got.backward()
        want, grads = jax.value_and_grad(
            lambda a, c: f(j_losses, a, c, jnp.asarray(w)), argnums=(0, 1))(
            jnp.asarray(u), jnp.asarray(i))
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   err_msg=name, **LOSS_TOL)
        for a, g in zip(tt, grads):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(g),
                                       err_msg=name, **GRAD_TOL)


def test_l2_normalize_is_finite_at_a_zero_row():
    x = np.array([[3.0, 4.0], [0.0, 0.0]], np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    l2_normalize(tx).sum().backward()
    np.testing.assert_allclose(l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(j_l2_normalize(jnp.asarray(x))),
                               **LOSS_TOL)
    assert torch.isfinite(tx.grad).all()


def test_tree_functions_and_params_from_numpy_on_nested_lists():
    """JAX's leaf order (sorted keys, sequences in order), lists and
    tuples kept, and Adam over a tree with lists as over the JAX one."""
    tree = {"b": [{"w": np.ones(2, np.float32), "b": np.zeros(1, np.float32)},
                  {"w": np.full(3, 2.0, np.float32)}],
            "a": (np.arange(2, dtype=np.float32),),
            "c": np.asarray(0.5, np.float32)}
    tp = params_from_numpy(tree, "cpu")
    assert isinstance(tp["b"], list) and isinstance(tp["a"], tuple)
    assert tp["c"].dim() == 0
    want = jax.tree_util.tree_leaves(tree)
    got = tree_leaves(tp)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    doubled = tree_map(lambda v: v * 2, tp)
    assert isinstance(doubled["a"], tuple)
    back = tree_unflatten(tp, [v * 3 for v in got])
    np.testing.assert_array_equal(back["b"][1]["w"].numpy(), [6.0] * 3)
    opt = make_optimizer(lr=0.1)
    state = opt.init(tp)
    opt.update(tree_map(torch.ones_like, tp), state, tp)
    assert isinstance(state["m"]["b"], list)
    np.testing.assert_allclose(tp["b"][1]["w"].numpy(), [1.9] * 3, rtol=1e-6)
