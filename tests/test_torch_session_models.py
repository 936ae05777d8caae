"""Port parity: the eight session models (SRGNN, NISER, TAGNN, GCSAN,
SGNNHN, GRU4Rec, NARM, SASRec).

From one JAX-initialised set of params (``params_from_numpy``) and the
fixture's padded last training batch: the ``train=False`` logits equal
the JAX package's, and so do the training loss, its parts and every
gradient, with the JAX dropout masks injected into the port
(``keeps=``, in the order the JAX forward draws them).  CE for all
eight, BPR for the models that offer it.  Tolerances: logits and loss
rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6; NISER's and
SGNNHN's logits are cosines times a scale (σ = 16, scale = 12), so
their atol is 1e-6 times that scale: the f32 rounding of a product of
unit vectors, scaled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_gnn_tpu_torch.eval.evaluator import to_device
from torch_parity_utils import (LOSS_TOL, both, check_loss_and_grads,
                                jax_globals, padded_batch, port_params,
                                seq_cfg, session_keeps)

MODELS = ["SRGNN", "NISER", "TAGNN", "GCSAN", "SGNNHN", "GRU4Rec", "NARM",
          "SASRec"]
# the published settings at narrow widths; SGNNHN at 2 of its 6 steps
OVER = {"SGNNHN": {"step": 2}, "GCSAN": {"step": 2},
        "NARM": {"hidden_size": 24}, "GRU4Rec": {"hidden_size": 24,
                                                 "num_layers": 2}}
BPR = {"loss_type": "BPR",
       "train_neg_sample_args": {"distribution": "uniform", "sample_num": 1}}


def run_case(monkeypatch, name, over):
    jax_globals(monkeypatch)
    (_, (jtl, _, _), jm), (_, _, tm) = both(seq_cfg(name, **over))
    batch = padded_batch(jtl)
    jp = jm.init_params(jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(0)
    j_logits = jm.full_scores(jp, jm.consts, {},
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              key, False)
    with torch.no_grad():
        t_logits = tm.full_scores(port_params(jp, grad=False), tm.consts, {},
                                  to_device(batch, "cpu"), None, False)
    assert t_logits.shape == (batch["item_seq"].shape[0], tm.n_items)
    scale = getattr(tm, "sigma", getattr(tm, "scale", 1.0))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=LOSS_TOL["rtol"],
                               atol=LOSS_TOL["atol"] * scale)
    keeps = session_keeps(name, jm, batch, key)
    kw = {} if keeps is None else {"keeps": keeps}
    tp, tg, _ = check_loss_and_grads(jm, tm, jp, batch, key, {}, {}, **kw)
    return tm, tg


@pytest.mark.parametrize("name", MODELS)
def test_logits_loss_and_grads_match_jax(monkeypatch, name):
    tm, tg = run_case(monkeypatch, name, OVER.get(name, {}))
    assert all(bool(torch.isfinite(g).all()) for g in tg)


@pytest.mark.parametrize("name", ["SRGNN", "NISER", "GCSAN", "SASRec"])
def test_bpr_loss_and_grads_match_jax(monkeypatch, name):
    run_case(monkeypatch, name, dict(OVER.get(name, {}), **BPR))


def test_dropout_draws_from_the_generator(monkeypatch):
    """Without injected masks the port draws from the trainer's
    generator: the same generator state gives the same loss, another
    gives another, and eval (train=False) draws nothing."""
    jax_globals(monkeypatch)
    (_, (jtl, _, _), jm), (_, _, tm) = both(seq_cfg("SASRec"))
    batch = to_device(padded_batch(jtl), "cpu")
    tp = port_params(jm.init_params(jax.random.PRNGKey(3)), grad=False)

    def loss(seed):
        g = torch.Generator().manual_seed(seed)
        return float(tm.calculate_loss(tp, tm.consts, {}, batch, g)[0])

    assert loss(1) == loss(1) != loss(2)
    g = torch.Generator().manual_seed(1)
    state = g.get_state()
    tm.full_scores(tp, tm.consts, {}, batch, g, False)
    assert torch.equal(g.get_state(), state)
