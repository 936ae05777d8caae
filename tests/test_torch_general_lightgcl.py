"""Port parity: LightGCL and the randomized SVD.

``randomized_svd`` / ``randomized_svd_sparse`` from the JAX Gaussian
sketch give the JAX factorisation: the reconstructions U·diag(s)·Vᵀ
within 1e-4 (the factors' signs may differ between the two LAPACK
calls; the product may not).  LightGCL from one JAX-initialised set of
params with the JAX sketch and dropout masks injected: the SVD views,
the loss, its parts and the gradients match on the dense graph, on
``ell`` (rectangular ELL layouts, the first on a training path), on
``pallas`` and on ``xla``, with and without value dropout; an ``ell``
config runs its rectangular graphs on the ELL path (K2 on the card),
not the segment SpMM (K1), and a ``pallas`` one on K1.

Tolerances: reconstructions 1e-4; loss and parts rtol 1e-5 / atol 1e-6;
gradients rtol 1e-4 / atol 1e-6.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.ops.svd import randomized_svd as j_randomized_svd
from recbole_gnn_tpu.ops.svd import \
    randomized_svd_sparse as j_randomized_svd_sparse
from recbole_gnn_tpu_torch.ops.svd import (full_f32_matmul, randomized_svd,
                                           randomized_svd_sparse)
from torch_parity_utils import (LOSS_TOL, both, cfg, check_loss_and_grads,
                                jax_globals, padded_batch, port_params, t)

t_spmm_mod = importlib.import_module("recbole_gnn_tpu_torch.ops.spmm")


def _recon(u, s, v):
    u, s, v = (np.asarray(a, np.float64) for a in (u, s, v))
    return (u * s[None, :]) @ v.T


def _sparse(rng, m=60, n=45, e=400):
    src, dst = rng.integers(0, m, e), rng.integers(0, n, e)
    return src, dst, rng.random(e).astype(np.float32), m, n


def test_randomized_svd_sparse_matches_jax():
    rng = np.random.default_rng(0)
    src, dst, w, m, n = _sparse(rng)
    q = 5
    key = jax.random.PRNGKey(3)
    omega = t(jax.random.normal(key, (n, q + 8), dtype=jnp.float32))
    ju, js, jv = j_randomized_svd_sparse(key, jnp.asarray(src),
                                         jnp.asarray(dst), jnp.asarray(w),
                                         m, n, q)
    tu, ts, tv = randomized_svd_sparse(None, torch.from_numpy(src),
                                       torch.from_numpy(dst),
                                       torch.from_numpy(w), m, n, q,
                                       omega=omega)
    assert tuple(tu.shape) == (m, q) and tuple(tv.shape) == (n, q)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4)
    np.testing.assert_allclose(_recon(tu, ts, tv), _recon(ju, js, jv),
                               atol=1e-4)
    # the leading singular value of the matrix itself
    a = np.zeros((m, n))
    np.add.at(a, (src, dst), w)
    np.testing.assert_allclose(float(ts[0]), np.linalg.norm(a, 2), rtol=1e-4)


def test_randomized_svd_operator_form_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(30, 20)).astype(np.float32)
    q = 4
    key = jax.random.PRNGKey(4)
    omega = t(jax.random.normal(key, (20, q + 8), dtype=jnp.float32))
    ja = jnp.asarray(a)
    ju, js, jv = j_randomized_svd(key, lambda x: ja @ x, lambda y: ja.T @ y,
                                  30, 20, q)
    ta = torch.from_numpy(a)
    tu, ts, tv = randomized_svd(None, lambda x: ta @ x, lambda y: ta.T @ y,
                                30, 20, q, omega=omega)
    np.testing.assert_allclose(_recon(tu, ts, tv), _recon(ju, js, jv),
                               atol=1e-4)


def test_full_f32_matmul_restores_settings():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        with full_f32_matmul():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])


def lightgcl_draws(jm, key, dense):
    """Per layer the value-dropout masks of one JAX training forward."""
    rng, out = key, []
    for _ in range(jm.n_layers):
        if dense:
            rng, k = jax.random.split(rng)
            out.append(t(jax.random.bernoulli(k, 1.0 - jm.dropout,
                                              jm.consts["adj"].shape)))
        else:
            rng, k1 = jax.random.split(rng)
            rng, k2 = jax.random.split(rng)
            out.append(tuple(
                t(jax.random.bernoulli(k, 1.0 - jm.dropout,
                                       jm.consts[g].weight.shape))
                for k, g in ((k1, "adj_ui"), (k2, "adj_iu"))))
    return out


CASES = [("dense", 0.0), ("dense", 0.2), ("ell", 0.0), ("ell", 0.2),
         ("pallas", 0.0), ("xla", 0.0)]


@pytest.mark.parametrize("graph,dropout", CASES,
                         ids=[f"{g}-{d}" for g, d in CASES])
def test_lightgcl_loss_and_grads_match_jax(monkeypatch, graph, dropout):
    jax_globals(monkeypatch)
    cd = cfg("LightGCL", graph, dropout=dropout)
    # the sketch JAX draws from PRNGKey(seed) at construction
    (_, (jtl, _, _), jm), (_, _, tm) = both(cd, lambda jm: {
        "svd_omega": t(jax.random.normal(jax.random.PRNGKey(cd["seed"]),
                                         (jm.n_items, jm.q + 8)))})
    # the SVD views: U·S·Vᵀ from both
    np.testing.assert_allclose(
        (tm.consts["u_mul_s"] @ tm.consts["vt"]).numpy(),
        np.asarray(jm.consts["u_mul_s"] @ jm.consts["vt"]), atol=1e-4)
    np.testing.assert_allclose(
        (tm.consts["v_mul_s"] @ tm.consts["ut"]).numpy(),
        np.asarray(jm.consts["v_mul_s"] @ jm.consts["ut"]), atol=1e-4)
    if graph != "dense":
        for g in ("adj_ui", "adj_iu"):
            tg = tm.consts[g]
            assert tg.impl == graph and tg.n_nodes != tg.n_src_nodes
            assert (tg.ell is not None) == (graph == "ell")
    calls = {"ell": 0, "pallas": 0}
    for name, fn in (("ell", "EllSpmmFunction"), ("pallas",
                                                  "SegmentSpmmFunction")):
        real = getattr(t_spmm_mod, fn).apply

        def count(*a, real=real, name=name):
            calls[name] += 1
            return real(*a)

        monkeypatch.setattr(getattr(t_spmm_mod, fn), "apply", count)
    jp = jm.init_params(jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(7)
    draws = lightgcl_draws(jm, key, graph == "dense") if dropout else None
    check_loss_and_grads(jm, tm, jp, padded_batch(jtl), key, {}, {},
                         draws=draws)
    # 2 rectangular SpMMs per layer; the ELL path on an ell config
    # (re-weighted graphs run xla), the segment SpMM on pallas
    want = 2 * tm.n_layers
    assert calls == {"ell": want if graph == "ell" and not dropout else 0,
                     "pallas": want if graph == "pallas" else 0}
    tu, ti = tm.propagate(port_params(jp), tm.consts, {})
    ju, ji = jm.propagate(jp, jm.consts, {})
    np.testing.assert_allclose(tu.detach().numpy(), np.asarray(ju), **LOSS_TOL)
    np.testing.assert_allclose(ti.detach().numpy(), np.asarray(ji), **LOSS_TOL)
