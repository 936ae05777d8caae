"""Port parity: DiffNet and MHCN.

From one JAX-initialised set of params and the fixture's padded last
training batch, the loss, its parts and every gradient of the port's
model equal the JAX model's, on the dense matrices (cuBLAS on the card)
and with ``enable_sparse: True`` on each of ``ell``, ``pallas`` and
``xla`` (on the CPU the sparse forms run through their kernels' plain
versions); MHCN with the JAX MIM permutations injected (``perms=``),
DiffNet also with frozen review embeddings (``pretrained_review``).
The JAX side is its dense form, compiled once per model (the JAX
package's own tests hold its sparse forms to its dense one).  The
port's device matrices are dense or sparse as the JAX package's are in
the same config, and each sparse one runs the impl the JAX package
dispatches it to.  The propagated tables equal the JAX ones.

Tolerances: loss and parts rtol 1e-5 / atol 1e-6, gradients and the
propagated tables rtol 1e-4 / atol 1e-6 (the sparse forms sum each row
in another order than the JAX dense product: MHCN's tables differed by
up to 1.1e-6 on entries of 5e-3 on ``xla``).
"""

import jax
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.ops.spmm import Graph as JGraph
from recbole_gnn_tpu_torch.eval.evaluator import to_device
from recbole_gnn_tpu_torch.ops.spmm import Graph
from torch_parity_utils import (GRAD_TOL, GRAPHS, both, cfg, jax_globals,
                                jax_loss_and_grads, mhcn_perms,
                                padded_batch, port_matches, port_params,
                                review_data)


def check_consts(jm, tm, graph):
    for k, v in jm.consts.items():
        if isinstance(v, JGraph):
            assert isinstance(tm.consts[k], Graph), k
            # SEPT's subgraph lacks the segment layout: segment sum
            want = ("xla" if graph == "pallas" and k == "sub_graph"
                    else graph if graph != "dense" else "ell")
            assert tm.consts[k].impl == want, (k, tm.consts[k].impl)
            assert (tm.consts[k].ell is not None) == (want == "ell"), k
        elif k in tm.consts and not isinstance(v, (int, float)):
            assert isinstance(tm.consts[k], torch.Tensor), k


@pytest.fixture(scope="module")
def reference():
    """The JAX dense model's loss, parts, gradients and propagated
    tables per (model, overrides), each computed once, with its params,
    batch and draws."""
    memo = {}

    def get(name, tmp_path=None, **over):
        k = (name, tuple(sorted((a, str(b)) for a, b in over.items())))
        if k not in memo:
            with pytest.MonkeyPatch.context() as mp:
                jax_globals(mp)
                (_, (jtl, _, _), jm), _ = both(cfg(name, "dense", **over))
                batch = padded_batch(jtl)
                jp = jm.init_params(jax.random.PRNGKey(3))
                key = jax.random.PRNGKey(0)
                kw = ({"perms": mhcn_perms(jm, key)} if name == "MHCN"
                      else {})
                memo[k] = (jp, batch, kw, jax_loss_and_grads(
                    jm, jp, batch, key, {}),
                    jm.propagate(jp, jm.consts, {}))
        return memo[k]

    return get


def check_model(reference, name, graph, **over):
    jp, batch, kw, want, (ju, ji) = reference(name, **over)
    (_, (jtl, _, _), jm), (_, _, tm) = both(cfg(name, graph, **over))
    check_consts(jm, tm, graph)
    _, tg, _ = port_matches(tm, jp, batch, {}, want, **kw)
    assert all(bool(torch.isfinite(g).all()) for g in tg)
    with torch.no_grad():
        tu, ti = tm.propagate(port_params(jp, grad=False), tm.consts, {})
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **GRAD_TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **GRAD_TOL)
    return tm


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("name", ["DiffNet", "MHCN"])
def test_loss_and_grads_match_jax(monkeypatch, reference, name, graph):
    jax_globals(monkeypatch)
    tm = check_model(reference, name, graph)
    sparse = [k for k, v in tm.consts.items() if isinstance(v, Graph)]
    assert (len(sparse) > 0) == (graph != "dense")
    if name == "MHCN" and graph != "dense":
        # rectangular interaction matrices, one per direction
        assert tm.consts["R_ui"].n_nodes == tm.n_users
        assert tm.consts["R_ui"].n_src_nodes == tm.n_items


@pytest.mark.parametrize("graph", ["dense", "ell"])
def test_diffnet_pretrained_review_matches_jax(monkeypatch, reference,
                                              tmp_path_factory, graph):
    jax_globals(monkeypatch)
    data = review_data(tmp_path_factory.mktemp(f"review-{graph}"))
    tm = check_model(reference, "DiffNet", graph, pretrained_review=True,
                     embedding_size=8, **data)
    assert tm.consts["user_review"].shape == (tm.n_users, 8)


def test_mhcn_permutations_from_the_generator(monkeypatch):
    """Without injected permutations MHCN draws them from the trainer's
    generator: the same state gives the same loss, another another."""
    jax_globals(monkeypatch)
    (_, (jtl, _, _), jm), (_, _, tm) = both(cfg("MHCN", ssl_reg=1.0))
    batch = to_device(padded_batch(jtl), "cpu")
    tp = port_params(jm.init_params(jax.random.PRNGKey(3)), grad=False)

    def loss(seed):
        g = torch.Generator().manual_seed(seed)
        return float(tm.calculate_loss(tp, tm.consts, {}, batch, g)[0])

    assert loss(1) == loss(1) != loss(2)
