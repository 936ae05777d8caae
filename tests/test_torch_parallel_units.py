"""Port parity, in one process: the parts of ``recbole_gnn_tpu_torch/
parallel/`` that need no process group — the mesh shapes and shorthand,
the tp pad plan and row-sharding rule, the batch and row slices, every
shard of the edge-sharded ELL SpMM run in one process (forward and
transpose, against the dense product and the JAX package's
``sharded_ell_spmm``) and the top-k over one block.  The collectives
themselves are held in ``test_torch_parallel_ranks.py``.

Tolerances: the SpMM sums the same f32 terms as the dense product in
another order, rtol / atol 2e-4 as the JAX tests state; top-k indices
exactly (continuous random scores, no ties).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recbole_gnn_tpu.parallel.sharded_spmm as j_sp
import recbole_gnn_tpu_torch.parallel.sharded_spmm as t_sp
from recbole_gnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from recbole_gnn_tpu.parallel.sharded_train import (
    shard_params_spec as j_spec, table_pad_plan as j_plan)
from recbole_gnn_tpu_torch.ops.ell_spmm import ell_spmm_plain, build_ell
from recbole_gnn_tpu_torch.ops.topk import full_sort_topk
from recbole_gnn_tpu_torch.parallel.mesh import (
    LocalMesh, batch_sharding, embedding_sharding, make_mesh, mesh_axes,
    replicated)
from recbole_gnn_tpu_torch.parallel.sharded_train import (
    pad_opt_state, pad_tables, place_batch, place_epoch_batches,
    shard_params_spec, table_pad_plan, unpad_opt_state, unpad_tables)
from recbole_gnn_tpu_torch.parallel.topk import distributed_full_sort_topk

SPMM_TOL = dict(rtol=2e-4, atol=2e-4)


class _Coord:
    """A mesh seen from one rank, for the helpers that read only the
    mesh's shape and this rank's coordinates."""

    def __init__(self, axes: dict, coords: dict):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())
        self._coords = coords

    def get_local_rank(self, axis):
        return self._coords[axis]


# -- mesh ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", [[4, 2], {"dp": 4, "tp": 2}, [2, 2, 2],
                                   None])
def test_mesh_axes_match_jax_shorthand(shape):
    assert mesh_axes(shape, 8) == dict(j_make_mesh(shape).shape)


def test_make_mesh_without_group():
    m = make_mesh([1])
    assert isinstance(m, LocalMesh) and m.mesh_dim_names == ("dp",)
    assert make_mesh(None).shape == (1,)
    assert make_mesh({"dp": 1, "tp": 1}).get_group("tp") is None
    with pytest.raises(ValueError, match="longer than 4"):
        make_mesh([1, 1, 1, 1, 1])
    with pytest.raises(ValueError, match="longer than 4"):
        j_make_mesh([1, 1, 1, 1, 1])
    with pytest.raises(ValueError, match=r"needs 8 ranks.* has 1.*torchrun"):
        make_mesh([4, 2])


def test_row_and_batch_slices():
    m = _Coord({"dp": 2, "tp": 2}, {"dp": 1, "tp": 0})
    assert embedding_sharding(m, 10) == slice(0, 5)
    assert batch_sharding(m, 8) == slice(4, 8)
    assert replicated(m, 7) == slice(0, 7)
    assert embedding_sharding(_Coord({"dp": 4}, {"dp": 3}), 10) == \
        slice(0, 10)                       # no tp axis: every row
    with pytest.raises(ValueError, match="do not divide"):
        batch_sharding(m, 7)
    b = {"user_id": np.arange(8), "x": np.arange(16).reshape(8, 2)}
    got = place_batch(b, m)
    np.testing.assert_array_equal(got["user_id"], [4, 5, 6, 7])
    np.testing.assert_array_equal(got["x"], b["x"][4:])
    st = place_epoch_batches({"u": np.arange(24).reshape(3, 8)}, m)
    np.testing.assert_array_equal(st["u"], np.arange(24).reshape(3, 8)[:, 4:])


# -- the pad plan and the row-sharding rule ------------------------------------

def _params(rng, n_users, n_items):
    return {"user_emb": rng.normal(size=(n_users, 4)).astype(np.float32),
            "item_emb": rng.normal(size=(n_items, 4)).astype(np.float32),
            "mlp": {"w": rng.normal(size=(4, 4)).astype(np.float32)}}


def test_pad_plan_and_spec_match_jax(caplog):
    rng = np.random.default_rng(0)
    p = _params(rng, 63, 97)
    mesh = _Coord({"dp": 4, "tp": 2}, {"dp": 0, "tp": 1})
    tp_ = {k: (torch.from_numpy(v) if k != "mlp" else
               {"w": torch.from_numpy(v["w"])}) for k, v in p.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    plan = table_pad_plan(tp_, mesh)
    assert plan == j_plan(jp, j_make_mesh({"dp": 4, "tp": 2})) == {
        "user_emb": (63, 64), "item_emb": (97, 98)}
    padded = pad_tables(tp_, plan)
    assert padded["user_emb"].shape == (64, 4)
    assert torch.equal(padded["user_emb"][63:], torch.zeros(1, 4))
    assert torch.equal(unpad_tables(padded, plan)["item_emb"], tp_["item_emb"])
    opt = {"m": tp_, "v": tp_, "t": torch.zeros((), dtype=torch.int32)}
    po = pad_opt_state(opt, plan)
    assert po["m"]["item_emb"].shape == (98, 4) and po["t"] is opt["t"]
    assert unpad_opt_state(po, plan)["v"]["user_emb"].shape == (63, 4)
    # the rule: divisible 2-D tables row-sharded, the rest replicated
    spec = shard_params_spec(padded, mesh)
    assert spec == {"user_emb": True, "item_emb": True, "mlp": {"w": False}}
    with caplog.at_level("WARNING", logger="recbole_gnn_tpu_torch"):
        odd = shard_params_spec(tp_, mesh)
    assert odd["user_emb"] is False and "not divisible" in caplog.text
    js = j_spec(jax.tree_util.tree_map(jnp.asarray, _params(rng, 16, 24)),
                j_make_mesh({"dp": 4, "tp": 2}))
    ts = shard_params_spec({k: torch.zeros(s.shape) for k, s in
                            (("user_emb", np.zeros((16, 4))),
                             ("item_emb", np.zeros((24, 4))))}, mesh)
    assert ts["user_emb"] == (js["user_emb"].spec[0] == "tp") is True


# -- the edge-sharded SpMM, every shard in one process --------------------------

def _dense(src, dst, w, n_dst, n_src):
    a = np.zeros((n_dst, n_src))
    np.add.at(a, (dst, src), w)
    return a


def _in_process(meta, x, cot):
    """Σ of the shards' local work: the forward blocks concatenated,
    the transpose shares summed."""
    out = torch.cat([t_sp.shard_forward(meta.shards[s], x)
                     for s in range(meta.n_shards)])[:meta.n_nodes]
    full = torch.zeros((meta.node_block * meta.n_shards, cot.shape[1]))
    full[:meta.n_nodes] = cot
    grad = sum(t_sp.shard_transpose(
        meta.shards[s], full[s * meta.node_block:(s + 1) * meta.node_block])
        for s in range(meta.n_shards))
    return out.numpy(), grad.numpy()


def _jax_sharded(src, dst, w, n_dst, n_src, x, cot):
    mesh = j_make_mesh({"dp": 4, "tp": 2})
    meta = j_sp.build_sharded_ell(src, dst, w, n_dst, 4, n_src_nodes=n_src)
    # jitted: an eager shard_map compiles op by op
    out = jax.jit(lambda x_: j_sp.sharded_ell_spmm(meta, x_, mesh, "dp"))(
        jnp.asarray(x))
    grad = jax.jit(jax.grad(lambda x_: jnp.sum(
        j_sp.sharded_ell_spmm(meta, x_, mesh, "dp") * jnp.asarray(cot))))(
            jnp.asarray(x))
    return np.asarray(out), np.asarray(grad), meta


@pytest.mark.parametrize("n_dst,n_src,e", [(53, 53, 400), (37, 29, 250)])
def test_sharded_spmm_shards_match_dense_and_jax(n_dst, n_src, e):
    rng = np.random.default_rng(31)
    src = rng.integers(0, n_src, e)
    dst = rng.integers(0, n_dst, e)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n_src, 8)).astype(np.float32)
    cot = rng.normal(size=(n_dst, 8)).astype(np.float32)
    meta = t_sp.build_sharded_ell(src, dst, w, n_dst, 4, n_src_nodes=n_src)
    assert sorted(meta.shards) == [0, 1, 2, 3]
    assert meta.n_edges == e
    out, grad = _in_process(meta, torch.from_numpy(x), torch.from_numpy(cot))
    a = _dense(src, dst, w, n_dst, n_src)
    np.testing.assert_allclose(out, a @ x, **SPMM_TOL)
    np.testing.assert_allclose(grad, a.T @ cot, **SPMM_TOL)
    j_out, j_grad, _ = _jax_sharded(src, dst, w, n_dst, n_src, x, cot)
    np.testing.assert_allclose(out, j_out, **SPMM_TOL)
    np.testing.assert_allclose(grad, j_grad, **SPMM_TOL)


def test_sharded_spmm_multi_vrow_heads(monkeypatch):
    """Hub nodes split into several virtual rows (K_CAP patched to 8 in
    both packages): the combine's split-node branch."""
    monkeypatch.setattr(t_sp, "K_CAP", 8)
    monkeypatch.setattr(j_sp, "K_CAP", 8)
    rng = np.random.default_rng(32)
    n, e = 41, 600
    src = rng.integers(0, n, e)
    dst = np.where(rng.random(e) < 0.5, rng.integers(0, 3, e),
                   rng.integers(0, n, e))
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    cot = rng.normal(size=(n, 8)).astype(np.float32)
    meta = t_sp.build_sharded_ell(src, dst, w, n, 4)
    assert meta.shards[0].fwd.n_multi > 0      # the branch is exercised
    out, grad = _in_process(meta, torch.from_numpy(x), torch.from_numpy(cot))
    a = _dense(src, dst, w, n, n)
    np.testing.assert_allclose(out, a @ x, **SPMM_TOL)
    np.testing.assert_allclose(grad, a.T @ cot, **SPMM_TOL)
    j_out, j_grad, j_meta = _jax_sharded(src, dst, w, n, n, x, cot)
    assert j_meta.fwd.n_multi > 0
    np.testing.assert_allclose(out, j_out, **SPMM_TOL)
    np.testing.assert_allclose(grad, j_grad, **SPMM_TOL)


def test_one_shard_is_the_unsharded_layout_and_differentiates():
    """A single shard holds the unsharded graph's layouts, element for
    element, and ``sharded_ell_spmm`` without a group is K2 forward and
    K2ᵀ back."""
    rng = np.random.default_rng(5)
    n, e = 30, 200
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    meta = t_sp.build_sharded_ell(src, dst, w, n, 1)
    order = np.argsort(dst, kind="stable")
    ref = build_ell(src[order], dst[order], w[order], n)
    for f in ("idx", "w", "node_src", "vdst", "vlen"):
        assert torch.equal(getattr(meta.local.fwd, f), getattr(ref, f)), f
    x = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    x.requires_grad_(True)
    out = t_sp.sharded_ell_spmm(meta, x)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ell_spmm_plain(ref, x).detach().numpy())
    cot = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    (out * cot).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(),
                               _dense(src, dst, w, n, n).T @ cot.numpy(),
                               **SPMM_TOL)
    with pytest.raises(ValueError, match="process group"):
        t_sp.sharded_ell_spmm(t_sp.build_sharded_ell(src, dst, w, n, 2), x)


def test_topk_over_one_block_is_full_sort():
    rng = np.random.default_rng(7)
    u = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    it = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    hist = np.full((16, 10), 63)
    hist[0] = np.arange(10)
    mask = torch.zeros(16, 64, dtype=torch.bool)
    mask.scatter_(1, torch.from_numpy(hist), True)
    want_v, want_i = full_sort_topk(u, it, mask, 5)
    v, i = distributed_full_sort_topk(u, it, torch.from_numpy(hist), 5, None)
    assert torch.equal(i, want_i)
    np.testing.assert_allclose(v.numpy(), want_v.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="exceeds"):
        distributed_full_sort_topk(u, it[:4], torch.from_numpy(hist), 5, None)
