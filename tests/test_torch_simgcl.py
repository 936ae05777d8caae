"""Port parity: SimGCL and XSimGCL, with their contrastive losses.

From one JAX-initialised set of params and the JAX-drawn noise (each
perturbed layer's ``jax.random.uniform`` under the step key's splits,
as ``simgcl.py:34-37, 51`` and ``xsimgcl.py:37`` draw it) injected into
the port, the loss, its parts and the embedding gradients match the JAX
model's on the fixture, on the sparse ``ell`` graph and on the dense
graph.  Then ``masked_unique`` / ``cl_nce_masked`` against JAX on a
batch with repeated ids and a fill row, and one short CPU run of each
model through ``run_recbole_gnn_tpu``.

Tolerances: loss and parts rtol 1e-5 / atol 1e-6, gradients rtol 1e-4
/ atol 1e-6 — the same f32 sums in another order through K layers, the
batch's logsumexp and the noise's norm (the CL gradient sums over every
unique id of the batch, ~300 terms per entry).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import base_config_dict
from recbole_gnn_tpu.config import Config as JConfig
from recbole_gnn_tpu.models import get_model as j_get_model
from recbole_gnn_tpu.models.losses import cl_nce_masked as j_cl_nce_masked
from recbole_gnn_tpu.models.losses import masked_unique as j_masked_unique
from recbole_gnn_tpu.quick_start import create_dataset as j_create_dataset
from recbole_gnn_tpu.quick_start import data_preparation as j_data_preparation
from recbole_gnn_tpu_torch.config import Config as TConfig
from recbole_gnn_tpu_torch.eval.evaluator import to_device
from recbole_gnn_tpu_torch.models import get_model as t_get_model
from recbole_gnn_tpu_torch.models.losses import cl_nce_masked, masked_unique
from recbole_gnn_tpu_torch.quick_start import create_dataset as t_create_dataset
from recbole_gnn_tpu_torch.quick_start import data_preparation as t_data_preparation
from recbole_gnn_tpu_torch.quick_start import run_recbole_gnn_tpu
from recbole_gnn_tpu_torch.train.checkpoint import params_from_numpy

j_spmm_mod = importlib.import_module("recbole_gnn_tpu.ops.spmm")

N_LAYERS = 2
GRAPHS = {"ell": {"enable_sparse": True, "sparse_spmm_impl": "ell"},
          "dense": {}}


def _cfg(model, **over):
    return base_config_dict(model=model, embedding_size=16, n_layers=N_LAYERS,
                            seed=2020, use_gpu=False, **over)


def _models(cd):
    out = []
    for cfg_cls, create, prep, get_model in (
            (JConfig, j_create_dataset, j_data_preparation, j_get_model),
            (TConfig, t_create_dataset, t_data_preparation, t_get_model)):
        c = cfg_cls(config_dict=cd)
        (tl, tr), _, _ = prep(c, create(c))
        out.append((tl, get_model(c["model"])(c, tr)))
    return out


def _jax_noise(key, n_layers, shape):
    """The per-layer draws of one perturbed JAX forward under ``key``."""
    out, rng = [], key
    for _ in range(n_layers):
        rng, k = jax.random.split(rng)
        out.append(torch.from_numpy(np.array(jax.random.uniform(k, shape))))
    return out


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("model", ["SimGCL", "XSimGCL"])
def test_loss_and_grads_match_jax(monkeypatch, model, graph):
    monkeypatch.setattr(j_spmm_mod, "SPMM_IMPL", j_spmm_mod.SPMM_IMPL)
    (jtl, jm), (_, tm) = _models(_cfg(model, **GRAPHS[graph]))
    if graph == "ell":
        assert tm.consts["graph"].ell is not None
        assert jm.consts["graph"].ell is not None
        assert j_spmm_mod.SPMM_IMPL == "ell"
    batch = list(jtl)[-1]                   # the padded last batch
    assert (batch["weight"] == 0).sum() > 0
    jp = jm.init_params(jax.random.PRNGKey(3))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    for v in tp.values():
        v.requires_grad_(True)
    key = jax.random.PRNGKey(7)
    shape = (jm.n_users + jm.n_items, 16)
    if model == "SimGCL":
        k1, k2 = jax.random.split(key)
        noise = (_jax_noise(k1, N_LAYERS, shape),
                 _jax_noise(k2, N_LAYERS, shape))
    else:
        noise = _jax_noise(key, N_LAYERS, shape)

    def j_loss(p):
        return jm.calculate_loss(p, jm.consts, {},
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 key)

    # one jit: op by op, JAX compiles each of ~400 small ops apart
    (jl, jaux), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(jp)
    tl, taux = tm.calculate_loss(tp, tm.consts, {}, to_device(batch, "cpu"),
                                 None, noise=noise)
    keys = sorted(tp)
    tg = torch.autograd.grad(tl, [tp[k] for k in keys])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-6)
    assert sorted(taux) == sorted(jaux) == ["cl", "mf", "reg"]
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k, g in zip(keys, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    # the evaluation's forward is unperturbed and leaves out layer 0
    tu, ti = tm.propagate(tp, tm.consts, {})
    ju, ji = jm.propagate(jp, jm.consts, {})
    np.testing.assert_allclose(tu.detach().numpy(), np.asarray(ju),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ti.detach().numpy(), np.asarray(ji),
                               rtol=1e-5, atol=1e-6)


def test_noise_is_drawn_from_the_generator():
    """Without injected noise the draws come from the trainer's
    generator: the same seed gives the same loss, another seed another."""
    (_, _), (ttl, tm) = _models(_cfg("XSimGCL"))
    gen = torch.Generator().manual_seed(0)
    params = tm.init_params(gen)
    batch = to_device(next(iter(ttl)), "cpu")
    losses = [float(tm.calculate_loss(params, tm.consts, {}, batch,
                                      torch.Generator().manual_seed(s))[0])
              for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]


IDS = np.array([5, 3, 5, 9, 3, 0, 7, 7], np.int64)   # repeats and a fill id


def test_masked_unique_matches_jax():
    u, m = masked_unique(torch.from_numpy(IDS))
    ju, jm_ = j_masked_unique(jnp.asarray(IDS))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm_))
    assert u.tolist() == [0, 3, 5, 7, 9, 0, 0, 0]


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_cl_nce_masked_matches_jax_with_finite_grads(reduction):
    """Fill rows (mask False, the 0 rows of masked_unique) count in
    neither the numerator nor the denominator; the gradient stays finite
    there because they are replaced before normalising."""
    rng = np.random.default_rng(4)
    u, m = masked_unique(torch.from_numpy(IDS))
    v1 = rng.normal(size=(8, 6)).astype(np.float32)
    v2 = rng.normal(size=(8, 6)).astype(np.float32)
    v1[~m.numpy()] = 0.0                     # a zero row where masked
    t1 = torch.from_numpy(v1).requires_grad_()
    t2 = torch.from_numpy(v2).requires_grad_()
    got = cl_nce_masked(t1, t2, 0.2, m, reduction)
    got.backward()
    jm_ = jnp.asarray(m.numpy())
    want, (g1, g2) = jax.value_and_grad(
        lambda a, b: j_cl_nce_masked(a, b, 0.2, jm_, reduction),
        argnums=(0, 1))(jnp.asarray(v1), jnp.asarray(v2))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for t, j in ((t1.grad, g1), (t2.grad, g2)):
        assert torch.isfinite(t).all()
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
        assert not t.numpy()[~m.numpy()].any()


@pytest.mark.parametrize("model", ["SimGCL", "XSimGCL"])
def test_cpu_run(tmp_path, model):
    res = run_recbole_gnn_tpu(
        model=model, dataset="test",
        config_dict=_cfg(model, checkpoint_dir=str(tmp_path), epochs=1,
                         **GRAPHS["ell"]),
        saved=True, verbose=False)
    assert res["test_result"] and all(np.isfinite(v) for v in
                                      res["test_result"].values())
    assert (tmp_path / f"{model}-test.ckpt").is_file()
