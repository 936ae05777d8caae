"""Port parity: NGCF and its pieces — ``bignn_conv`` / ``bignn_params``,
``linear`` / ``linear_params``, ``spmm_dense_bipartite_dropout`` — and
NGCF's loss, parts and gradients from one JAX-initialised set of
params, with the JAX draws (edge and message masks) injected, on the
dense graph, the sparse ``ell`` graph (which runs ``xla`` for a step
with edge dropout, as the JAX package runs its segment sum) and
``xla``.

Tolerances: loss and parts rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 /
atol 1e-6 (the same f32 sums in another order through the layers).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.models.init import linear as j_linear
from recbole_gnn_tpu.models.init import linear_params as j_linear_params
from recbole_gnn_tpu.models.layers import bignn_conv as j_bignn_conv
from recbole_gnn_tpu.models.layers import bignn_params as j_bignn_params
from recbole_gnn_tpu.ops.spmm import build_dense_bipartite as j_build_dense
from recbole_gnn_tpu.ops.spmm import build_graph as j_build_graph
from recbole_gnn_tpu.ops.spmm import \
    spmm_dense_bipartite_dropout as j_dense_dropout
from recbole_gnn_tpu_torch.models.init import linear, linear_params
from recbole_gnn_tpu_torch.models.layers import bignn_conv, bignn_params
from recbole_gnn_tpu_torch.ops.spmm import (build_dense_bipartite,
                                            build_graph,
                                            spmm_dense_bipartite_dropout)
from torch_parity_utils import (GRAD_TOL, LOSS_TOL, both, cfg,
                                check_loss_and_grads, jax_bernoulli_keeps,
                                j_spmm_mod, jax_globals, padded_batch,
                                port_params, t)

t_spmm_mod = importlib.import_module("recbole_gnn_tpu_torch.ops.spmm")


def _graph(rng, n=40, e=300):
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return src, dst, rng.random(e).astype(np.float32), n


def test_linear_and_params_match_jax():
    rng = np.random.default_rng(0)
    jp = j_linear_params(jax.random.PRNGKey(1), 6, 4)
    tp = port_params(jp, grad=False)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    np.testing.assert_allclose(linear(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(j_linear(jp, jnp.asarray(x))),
                               **LOSS_TOL)
    # the same structure and laws: xavier weights and zero bias, or both
    # uniform on ±stdv; no bias when asked
    gen = torch.Generator().manual_seed(0)
    for kw, lim in (({}, np.sqrt(6 / 300)), ({"stdv": 0.25}, 0.25),
                    ({"bias": False}, np.sqrt(6 / 300))):
        p = linear_params(gen, 200, 100, **kw)
        q = j_linear_params(jax.random.PRNGKey(2), 200, 100, **kw)
        assert sorted(p) == sorted(q)
        for k in p:
            assert tuple(p[k].shape) == q[k].shape
            assert float(p[k].abs().max()) <= lim
        assert float(p["w"].abs().max()) > 0.9 * lim
        if "stdv" in kw:
            assert float(p["b"].abs().max()) > 0.9 * lim
        elif "b" in p:
            assert not p["b"].any() and not np.asarray(q["b"]).any()


@pytest.mark.parametrize("impl", ["ell", "xla", "pallas"])
def test_bignn_conv_matches_jax(monkeypatch, impl):
    rng = np.random.default_rng(1)
    src, dst, w, n = _graph(rng)
    jp = j_bignn_params(jax.random.PRNGKey(3), 8, 5)
    tp = port_params(jp)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    jg = j_build_graph(src, dst, w, n)
    own = bignn_params(torch.Generator().manual_seed(0), 8, 5)
    assert {k: {kk: tuple(v.shape) for kk, v in d.items()}
            for k, d in own.items()} == {
        k: {kk: v.shape for kk, v in d.items()} for k, d in jp.items()}
    monkeypatch.setattr(j_spmm_mod, "SPMM_IMPL",
                        "ell" if impl == "ell" else "xla")
    tg = build_graph(src, dst, w, n, device="cpu", impl=impl,
                     with_pallas=impl == "pallas")

    def jf(p, xx):
        return jnp.sum(j_bignn_conv(p, jg, xx) ** 2)

    jv, (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = bignn_conv(tp, tg, tx)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(j_bignn_conv(jp, jg, jnp.asarray(x))),
                               **LOSS_TOL)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    for a, b in (("lin1", "w"), ("lin1", "b"), ("lin2", "w"), ("lin2", "b")):
        np.testing.assert_allclose(tp[a][b].grad.numpy(),
                                   np.asarray(jgp[a][b]), **GRAD_TOL)


def test_dense_bipartite_dropout_matches_jax():
    rng = np.random.default_rng(2)
    nu, ni, e = 7, 9, 30
    u, i = rng.integers(0, nu, e), rng.integers(0, ni, e)
    w = rng.random(e).astype(np.float32)
    jg = j_build_dense(u, i, w, nu, ni)
    tg = build_dense_bipartite(u, i, w, nu, ni, device="cpu")
    x = rng.normal(size=(nu + ni, 4)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    masks = tuple(t(jax.random.bernoulli(k, 0.7, (nu, ni))) for k in (k1, k2))
    want = j_dense_dropout(jg, jnp.asarray(x), key, 0.3)
    got = spmm_dense_bipartite_dropout(tg, torch.from_numpy(x), masks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


def ngcf_draws(jm, key, node_dropout, message_dropout, graph):
    """The draws of one JAX NGCF training forward under ``key``."""
    rng = key
    draws = {}
    if node_dropout > 0:
        rng, drop_key = jax.random.split(rng)
        if graph == "dense":
            a = jm.consts["graph"].a
            k1, k2 = jax.random.split(drop_key)
            draws["edge_keep"] = tuple(
                t(jax.random.bernoulli(k, 1.0 - node_dropout, a.shape))
                for k in (k1, k2))
        else:
            n = jm.consts["graph"].n_edges_padded
            draws["edge_keep"] = t(jax.random.uniform(drop_key, (n,))
                                   >= node_dropout)
    if message_dropout > 0:
        n = jm.n_users + jm.n_items
        shapes = [(n, d) for d in jm.hidden_size_list[1:]]
        draws["msg_keep"] = jax_bernoulli_keeps(rng, shapes, message_dropout)
    return draws


@pytest.mark.parametrize("graph,node_dropout", [
    ("dense", 0.0), ("dense", 0.2), ("ell", 0.0), ("ell", 0.2),
    ("xla", 0.0)])
def test_ngcf_loss_and_grads_match_jax(monkeypatch, graph, node_dropout):
    jax_globals(monkeypatch)
    cd = cfg("NGCF", graph, hidden_size_list=[16, 12],
             node_dropout=node_dropout, message_dropout=0.1)
    (_, (jtl, _, _), jm), (_, _, tm) = both(cd)
    if graph == "ell":
        assert tm.consts["graph"].ell is not None
    batch = padded_batch(jtl)
    jp = jm.init_params(jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(7)
    draws = ngcf_draws(jm, key, node_dropout, 0.1, graph)
    if graph == "ell" and node_dropout > 0:
        # the re-weighted graph runs xla: the K2 path is never taken
        calls = []
        real = t_spmm_mod.EllSpmmFunction.apply
        monkeypatch.setattr(t_spmm_mod.EllSpmmFunction, "apply",
                            lambda *a: calls.append(1) or real(*a))
        check_loss_and_grads(jm, tm, jp, batch, key, {}, {}, draws=draws)
        assert not calls
    else:
        check_loss_and_grads(jm, tm, jp, batch, key, {}, {}, draws=draws)
    # the evaluation forward: no dropout
    tu, ti = tm.propagate(port_params(jp), tm.consts, {})
    ju, ji = jm.propagate(jp, jm.consts, {})
    np.testing.assert_allclose(tu.detach().numpy(), np.asarray(ju), **LOSS_TOL)
    np.testing.assert_allclose(ti.detach().numpy(), np.asarray(ji), **LOSS_TOL)


def test_ngcf_draws_from_the_generator():
    """Without injected draws the masks come from the trainer's
    generator: the same seed gives the same loss, another seed another."""
    (_, (jtl, _, _), _), (_, _, tm) = both(
        cfg("NGCF", "ell", hidden_size_list=[16], node_dropout=0.2,
            message_dropout=0.1))
    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    params = tm.init_params(torch.Generator().manual_seed(0))
    batch = to_device(next(iter(jtl)), "cpu")
    losses = [float(tm.calculate_loss(params, tm.consts, {}, batch,
                                      torch.Generator().manual_seed(s))[0])
              for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]
