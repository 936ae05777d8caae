"""Port parity: the session layers and the places where the port's form
differs from the JAX package's.

* the sparse ``srgnn_cell`` over a batch's disjoint-union session graph
  (``session_union_graphs``) on ``ell``, ``pallas`` and ``xla`` (their
  CPU plain versions) against JAX's ``srgnn_cell`` over the same graph
  and against the dense cell, values and gradients;
* TAGNN's chunked target scores (``s·bₙ + Σ_l β_nl (h_l·bₙ)`` over item
  chunks, checkpointed under autograd) against the JAX (B, n, D) form,
  scores and the CE loss's gradients, with chunks that do not divide
  the catalog;
* the dense adjacency of a session ``[a, a, b]``, whose real 0→0 edge
  shares its cell with every padded edge slot;
* ``gru_scan``'s masked steps and ``gru_step``, the post-LN
  transformer encoder with injected dropout masks, ``layer_norm`` and
  the causal mask.

Tolerances: values rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 /
atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.models import layers as j_layers
from recbole_gnn_tpu.models.sequential import common as j_common
from recbole_gnn_tpu.ops.spmm import build_graph as j_build_graph
from recbole_gnn_tpu_torch.eval.evaluator import to_device
from recbole_gnn_tpu_torch.models import layers as t_layers
from recbole_gnn_tpu_torch.models.sequential import common as t_common
from recbole_gnn_tpu_torch.models.sequential import tagnn as t_tagnn
from torch_parity_utils import (GRAD_TOL, LOSS_TOL, both,
                                check_loss_and_grads, jax_bernoulli_keeps,
                                jax_globals, padded_batch, port_params,
                                seq_cfg, t)

D = 16


def fixture_batch(monkeypatch, model="SRGNN"):
    jax_globals(monkeypatch)
    (_, (jtl, _, _), jm), (_, _, tm) = both(seq_cfg(model))
    return padded_batch(jtl), jm, tm


@pytest.mark.parametrize("impl", ["ell", "pallas", "xla"])
def test_sparse_srgnn_cell_matches_jax_and_dense(monkeypatch, impl):
    batch, _, _ = fixture_batch(monkeypatch)
    B, L = batch["x"].shape
    jp = j_layers.srgnn_cell_params(jax.random.PRNGKey(1), D)
    # node states at the models' embedding scale (uniform ±1/√D)
    hidden = np.random.default_rng(2).uniform(
        -D ** -0.5, D ** -0.5, size=(B, L, D)).astype(np.float32)
    in_g, out_g = t_common.session_union_graphs(batch, device="cpu",
                                                impl=impl)
    assert in_g.impl == impl and in_g.n_nodes == B * L
    assert in_g.nnz == int(batch["n_edges"].sum())
    # JAX's cell over the same union graph (its build from the same edges)
    j_in = j_build_graph(in_g.src[:in_g.nnz].numpy(),
                         in_g.dst[:in_g.nnz].numpy(),
                         in_g.weight[:in_g.nnz].numpy(), B * L)
    j_out = j_build_graph(out_g.src[:out_g.nnz].numpy(),
                          out_g.dst[:out_g.nnz].numpy(),
                          out_g.weight[:out_g.nnz].numpy(), B * L)
    # a mean over the nodes, as a loss takes it
    g_out = (np.random.default_rng(3).normal(size=(B * L, D))
             / (B * L)).astype(np.float32)

    def j_obj(p, h):
        return jnp.sum(j_layers.srgnn_cell(p, h, j_in, j_out) * g_out)

    j_val = j_layers.srgnn_cell(jp, jnp.asarray(hidden.reshape(B * L, D)),
                                j_in, j_out)
    j_gp, j_gh = jax.grad(j_obj, argnums=(0, 1))(
        jp, jnp.asarray(hidden.reshape(B * L, D)))
    tp = port_params(jp)
    h = torch.from_numpy(hidden.reshape(B * L, D)).requires_grad_(True)
    out = t_layers.srgnn_cell(tp, h, in_g, out_g)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_val),
                               **LOSS_TOL)
    grads = torch.autograd.grad((out * torch.from_numpy(g_out)).sum(),
                                [h, tp["in_conv"]["w"], tp["lin_hh"]["w"]])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(j_gh), **GRAD_TOL)
    np.testing.assert_allclose(grads[1].numpy(),
                               np.asarray(j_gp["in_conv"]["w"]), **GRAD_TOL)
    np.testing.assert_allclose(grads[2].numpy(),
                               np.asarray(j_gp["lin_hh"]["w"]), **GRAD_TOL)
    # the dense cell over the same batch
    tb = to_device(batch, "cpu")
    a_in, a_out = t_common.session_dense_adj(tb)
    dense = t_common.srgnn_cell_dense(tp, torch.from_numpy(hidden), a_in,
                                      a_out)
    np.testing.assert_allclose(out.detach().numpy(),
                               dense.detach().numpy().reshape(B * L, D),
                               **LOSS_TOL)


def test_dense_adjacency_of_a_repeated_first_item():
    """[a, a, b]: the real edge 0→0 and the padded slots share cell
    (0, 0); a max-scatter keeps its 1."""
    L = 6
    seqs = np.zeros((2, L), np.int32)
    seqs[0, :3] = [7, 7, 9]
    seqs[1, :4] = [4, 4, 4, 5]
    lens = np.array([3, 4], np.int32)
    from recbole_gnn_tpu_torch.data.session import build_session_graphs
    g = build_session_graphs(seqs, lens, L)
    np.testing.assert_array_equal(g["edge_src"][0, :2], [0, 0])
    np.testing.assert_array_equal(g["edge_dst"][0, :2], [0, 1])
    batch = dict(g, item_seq=seqs, item_seq_len=lens)
    t_in, t_out = t_common.session_dense_adj(to_device(batch, "cpu"))
    j_in, j_out = j_common.session_dense_adj(
        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_array_equal(t_in.numpy(), np.asarray(j_in))
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    # row 0 of A_in: the self-edge alone; row 1: from node 0
    np.testing.assert_array_equal(t_in[0, :2, :2].numpy(), [[1, 0], [1, 0]])
    np.testing.assert_array_equal(t_out[0, 0, :2].numpy(), [0.5, 0.5])
    assert float(t_in[1, 0, 0]) == 1.0


@pytest.mark.parametrize("chunk", [None, 7, 333])
def test_tagnn_chunked_scores_match_jax_form(monkeypatch, chunk):
    """Scores (train=False) and the CE loss's gradients, the chunks'
    checkpointed recomputation included."""
    batch, jm, tm = fixture_batch(monkeypatch, "TAGNN")
    jp = jm.init_params(jax.random.PRNGKey(5))
    if chunk is not None:     # force the chunking
        monkeypatch.setattr(t_tagnn, "SCORE_BYTES_BUDGET",
                            batch["x"].shape[0] * batch["x"].shape[1] * 4
                            * chunk)
    j_val = jm.full_scores(jp, jm.consts, {},
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           None, False)
    with torch.no_grad():
        scores = tm.full_scores(port_params(jp, grad=False), tm.consts, {},
                                to_device(batch, "cpu"), None, False)
    np.testing.assert_allclose(scores.numpy(), np.asarray(j_val), **LOSS_TOL)
    check_loss_and_grads(jm, tm, jp, batch, jax.random.PRNGKey(0), {}, {})


def test_gru_scan_masked_steps_keep_the_state():
    rng = np.random.default_rng(7)
    B, T, H = 5, 6, 8
    jp = j_layers.gru_params(jax.random.PRNGKey(2), D, H)
    xs = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = rng.random((B, T)) < 0.6
    mask[0] = False
    h0 = rng.normal(size=(B, H)).astype(np.float32)
    j_states, j_last = j_layers.gru_scan(jp, jnp.asarray(xs),
                                         jnp.asarray(h0), jnp.asarray(mask))
    t_states, t_last = t_layers.gru_scan(port_params(jp, grad=False),
                                         torch.from_numpy(xs),
                                         torch.from_numpy(h0),
                                         torch.from_numpy(mask))
    np.testing.assert_allclose(t_states.numpy(), np.asarray(j_states),
                               **LOSS_TOL)
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), **LOSS_TOL)
    # a row masked everywhere keeps h0 at every step
    np.testing.assert_array_equal(t_states[0].numpy(), np.repeat(h0[:1], T, 0))
    # one step alone (LESSR's EOP aggregation takes it)
    np.testing.assert_allclose(
        t_layers.gru_step(port_params(jp, grad=False), torch.from_numpy(h0),
                          torch.from_numpy(xs[:, 0])).numpy(),
        np.asarray(j_layers.gru_step(jp, jnp.asarray(h0),
                                     jnp.asarray(xs[:, 0]))), **LOSS_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_transformer_encoder_matches_jax(train):
    rng = np.random.default_rng(8)
    B, T, heads = 4, 7, 2
    jp = j_layers.transformer_params(jax.random.PRNGKey(4), 2, heads, D,
                                     2 * D)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    valid = np.arange(T)[None, :] < np.array([7, 3, 1, 5])[:, None]
    j_mask = j_layers.causal_additive_mask(jnp.asarray(valid))
    t_mask = t_layers.causal_additive_mask(torch.from_numpy(valid))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    assert float(t_mask.min()) == -1e9
    key = jax.random.PRNGKey(9) if train else None
    j_out = j_layers.transformer_encoder(
        jp, jnp.asarray(x), j_mask, dropout_rng=key,
        dropout=0.3 if train else 0.0, n_heads=heads,
        attn_dropout=0.2 if train else 0.0)
    stream = None
    if train:
        shapes = [(B, heads, T, T), (B, T, D), (B, T, D)] * 2
        stream = t_layers.KeepStream(keeps=jax_bernoulli_keeps(
            key, shapes, [0.2, 0.3, 0.3] * 2))
    t_out = t_layers.transformer_encoder(
        port_params(jp, grad=False), torch.from_numpy(x), t_mask,
        keeps=stream, dropout=0.3 if train else 0.0, n_heads=heads,
        attn_dropout=0.2 if train else 0.0)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **LOSS_TOL)
    if train:
        assert len(stream.drawn) == 6


def test_layer_norm_matches_jax():
    x = np.random.default_rng(10).normal(size=(3, 5, D)).astype(np.float32)
    p = {"g": np.linspace(0.5, 2, D).astype(np.float32),
         "b": np.linspace(-1, 1, D).astype(np.float32)}
    want = j_layers.layer_norm({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x))
    got = t_layers.layer_norm({k: t(v) for k, v in p.items()},
                              torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)
