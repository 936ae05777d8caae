"""Port parity: K5, the segment reductions (``ops/segment.py``).

The port's ``segment_sum`` / ``segment_mean`` / ``segment_max`` /
``segment_softmax`` (PyTorch ``index_add_`` and ``scatter_reduce``)
against ``recbole_gnn_tpu/ops/segment.py`` on the same inputs: unsorted
ids, empty segments (0 for the sum and the mean, −inf for the max),
masked and fully masked softmax segments (probability 0, zeros rather
than NaN), rows with a trailing feature axis, and the softmax's
gradient.  ``edge_attention`` is the softmax by destination.
Tolerance: rtol 1e-6 / atol 1e-7 on values, rtol 1e-5 / atol 1e-6 on
gradients (f32 sums in another order; a softmax gradient
p_i (w_i − Σ p_j w_j) cancels toward 0, and JAX also differentiates
through the segment max, whose terms cancel exactly only in exact
arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.models.layers import edge_attention as j_edge_attention
from recbole_gnn_tpu.ops import segment as j_seg
from recbole_gnn_tpu_torch.models.layers import edge_attention as t_edge_attention
from recbole_gnn_tpu_torch.ops import segment as t_seg

VAL_TOL = dict(rtol=1e-6, atol=1e-7)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def case(seed, n, n_seg, tail=(), sort=False):
    rng = np.random.default_rng(seed)
    # segments 0 and n_seg - 1 left empty on purpose
    ids = rng.integers(1, max(2, n_seg - 1), n).astype(np.int64)
    if sort:
        ids = np.sort(ids)
    data = rng.normal(size=(n,) + tail).astype(np.float32) * 3
    return data, ids


@pytest.mark.parametrize("tail", [(), (4,), (2, 3)])
@pytest.mark.parametrize("op", ["segment_sum", "segment_mean",
                                "segment_max"])
@pytest.mark.parametrize("sort", [False, True])
def test_reductions_match_jax(op, tail, sort):
    data, ids = case(1, 300, 40, tail, sort)
    got = getattr(t_seg, op)(torch.from_numpy(data), torch.from_numpy(ids),
                             40).numpy()
    want = np.asarray(getattr(j_seg, op)(jnp.asarray(data), jnp.asarray(ids),
                                         40))
    np.testing.assert_allclose(got, want, **VAL_TOL)
    empty = np.setdiff1d(np.arange(40), ids)
    assert len(empty) >= 2
    fill = -np.inf if op == "segment_max" else 0.0
    assert (got[empty] == fill).all()


MASKS = ["none", "some", "segment_fully_masked", "all"]


def softmax_case(mask_kind):
    logits, ids = case(2, 200, 30, sort=False)
    rng = np.random.default_rng(3)
    if mask_kind == "none":
        mask = None
    elif mask_kind == "some":
        mask = rng.random(200) < 0.7
    elif mask_kind == "segment_fully_masked":
        mask = (ids != 5) & (ids != 11)
    else:
        mask = np.zeros(200, bool)
    return logits, ids, mask


@pytest.mark.parametrize("mask_kind", MASKS)
def test_softmax_and_grad_match_jax(mask_kind):
    logits, ids, mask = softmax_case(mask_kind)
    w = np.random.default_rng(4).normal(size=200).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)

    def j_obj(x):
        return jnp.sum(j_seg.segment_softmax(x, jnp.asarray(ids), 30,
                                             mask=jm) * w)

    j_val = np.asarray(j_seg.segment_softmax(jnp.asarray(logits),
                                             jnp.asarray(ids), 30, mask=jm))
    j_grad = np.asarray(jax.grad(j_obj)(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_(True)
    t_val = t_seg.segment_softmax(x, torch.from_numpy(ids), 30, mask=tm)
    (t_grad,) = torch.autograd.grad((t_val * torch.from_numpy(w)).sum(), x)
    t_val = t_val.detach().numpy()
    np.testing.assert_allclose(t_val, j_val, **VAL_TOL)
    np.testing.assert_allclose(t_grad.numpy(), j_grad, **GRAD_TOL)
    assert np.isfinite(t_val).all() and np.isfinite(t_grad.numpy()).all()
    if mask is not None:
        assert (t_val[~mask] == 0).all()
    # each segment with an unmasked entry sums to 1, the others to 0
    sums = np.bincount(ids, weights=t_val, minlength=30)
    live = np.unique(ids if mask is None else ids[mask])
    np.testing.assert_allclose(sums[live], 1.0, rtol=1e-5)
    dead = np.setdiff1d(np.arange(30), live)
    assert (sums[dead] == 0).all()


def test_edge_attention_matches_jax():
    logits, ids, mask = softmax_case("some")
    got = t_edge_attention(torch.from_numpy(logits), torch.from_numpy(ids),
                           30, mask=torch.from_numpy(mask)).numpy()
    want = np.asarray(j_edge_attention(jnp.asarray(logits), jnp.asarray(ids),
                                       30, mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, **VAL_TOL)
