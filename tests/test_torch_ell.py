"""Port parity: the bucketed-ELL SpMM (K2, ``sparse_spmm_impl: ell``).

The port's host layout (``build_ell``) against the JAX package's,
element for element; the plain ``ell_spmm`` (the CPU path) against JAX
``ell_spmm`` and its bucket chunking; ``EllSpmmFunction`` and the graph
dispatch against JAX ``spmm`` with ELL selected, forward and x-gradient;
``with_weight(rebuild_ell=True)``, ``reverse()`` and the layout-less
``ell`` graph; and the kernel's write plan (``vdst`` and the ``rest``
list) replayed in numpy.  The CUDA kernel itself runs only on the card;
``chip_smoke.py`` holds it against the same plain version there.

Tolerances: the plain version and the JAX package sum the same f32
terms in another order, so outputs and gradients agree to rtol 1e-5 /
atol 1e-5 on these unit-scale inputs (a hub row sums a few hundred
terms of magnitude ~1 to at most ~50); the layouts are compared
exactly.
"""

import dataclasses
import importlib
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.ops import ell_spmm as j_ell
from recbole_gnn_tpu.ops.spmm import build_graph as j_build_graph
from recbole_gnn_tpu_torch.ops import cuda_build
from recbole_gnn_tpu_torch.ops import ell_spmm as t_ell
from recbole_gnn_tpu_torch.ops.spmm import EllSpmmFunction, build_graph, spmm

j_spmm_mod = importlib.import_module("recbole_gnn_tpu.ops.spmm")

RTOL, ATOL = 1e-5, 1e-5


def _graph(name):
    """(src, dst, w, n_dst, n_src, build_ell kwargs) of a few thousand
    edges: a Zipf hub graph, the same with k_cap 8 (most nodes split into
    virtual rows), isolated nodes on a rectangular graph, and a 3-bucket
    grid."""
    rng = np.random.default_rng({"zipf": 1, "split": 2, "rect": 3,
                                 "few_buckets": 4}[name])
    if name == "rect":
        n_dst, n_src, e = 120, 300, 2500
        dst = rng.integers(1, n_dst - 10, e)   # row 0 and the top 10 empty
        src = rng.integers(0, n_src, e)
    else:
        n_dst = n_src = 400
        e = 4000
        dst = (rng.zipf(1.3, e) - 1) % n_dst
        src = rng.integers(0, n_src, e)
    kw = {"split": {"k_cap": 8}, "few_buckets": {"max_buckets": 3}}.get(
        name, {})
    return src, dst, rng.normal(size=e).astype(np.float32), n_dst, n_src, kw


NAMES = ["zipf", "split", "rect", "few_buckets"]


def _sorted(src, dst, w):
    o = np.argsort(dst, kind="stable")
    return src[o], dst[o], w[o]


@pytest.mark.parametrize("edge_ids", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_build_ell_equals_jax(name, edge_ids):
    src, dst, w, n_dst, _, kw = _graph(name)
    s, d, ww = _sorted(src, dst, w)
    ids = (np.random.default_rng(9).permutation(len(s)) if edge_ids
           else None)
    jm = j_ell.build_ell(s, d, ww, n_dst, with_epos=True, edge_ids=ids, **kw)
    tm = t_ell.build_ell(s, d, ww, n_dst, with_epos=True, edge_ids=ids, **kw)
    assert len(tm.idxs) == len(jm.idxs) and tm.n_multi == jm.n_multi
    assert tm.n_nodes == jm.n_nodes and tm.e_padded == jm.e_padded
    for field in ("idxs", "ws", "eposs"):
        for a, b in zip(getattr(jm, field), getattr(tm, field)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=field)
    np.testing.assert_array_equal(tm.node_src.numpy(), np.asarray(jm.node_src))
    if name == "split":
        assert jm.n_multi > 0
    if jm.n_multi:
        np.testing.assert_array_equal(tm.mgidx.numpy(), np.asarray(jm.mgidx))
        np.testing.assert_array_equal(tm.msegs.numpy(), np.asarray(jm.msegs))
    else:
        assert tm.mgidx is None and jm.mgidx is None
    if name == "rect":
        assert (np.bincount(dst, minlength=n_dst) == 0).sum() >= 11


@pytest.mark.parametrize("name", NAMES)
def test_kernel_write_plan_covers_every_node_once(name):
    """The kernel's plan replayed in numpy: each virtual row goes to its
    node (vdst >= 0) or a workspace row; the second pass sums each split
    node's workspace rows and zeroes each isolated node.  Every node is
    written once and the result is the plain version's."""
    src, dst, w, n_dst, n_src, kw = _graph(name)
    m = t_ell.build_ell(*_sorted(src, dst, w), n_dst, **kw)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(n_src, 8)).astype(np.float32))
    vr = torch.cat([t_ell._bucket_sum(x, i, ww, 8)
                    for i, ww in zip(m.idxs, m.ws)])
    assert m.vdst.shape[0] == vr.shape[0] == m.n_vrows
    out = torch.full((n_dst, 8), float("nan"))
    ws = torch.full((max(m.n_multi_vrows, 1), 8), float("nan"))
    writes = np.zeros(n_dst, int)
    for v, t in enumerate(m.vdst.tolist()):
        if t >= 0:
            out[t] = vr[v]
            writes[t] += 1
        else:
            ws[-1 - t] = vr[v]
    for node, start, count in zip(m.rest_node.tolist(),
                                  m.rest_start.tolist(),
                                  m.rest_count.tolist()):
        out[node] = ws[start:start + count].sum(0) if count else 0.0
        writes[node] += 1
    assert (writes == 1).all()
    np.testing.assert_allclose(out.numpy(), t_ell.ell_spmm_plain(m, x).numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_plain_ell_spmm_matches_jax(name):
    src, dst, w, n_dst, n_src, kw = _graph(name)
    s, d, ww = _sorted(src, dst, w)
    x = np.random.default_rng(6).normal(size=(n_src, 16)).astype(np.float32)
    want = np.asarray(j_ell.ell_spmm(j_ell.build_ell(s, d, ww, n_dst, **kw),
                                     jnp.asarray(x)))
    tm = t_ell.build_ell(s, d, ww, n_dst, **kw)
    before = t_ell.ell_spmm.launches
    got = t_ell.ell_spmm(tm, torch.from_numpy(x))
    assert t_ell.ell_spmm.launches == before        # CPU: no launch
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    oracle = np.zeros((n_dst, 16))
    np.add.at(oracle, dst, w.astype(np.float64)[:, None] * x[src])
    np.testing.assert_allclose(got.numpy(), oracle, rtol=RTOL, atol=ATOL)
    if name == "rect":
        assert not got.numpy()[np.bincount(dst, minlength=n_dst) == 0].any()


def test_plain_bucket_chunks_match_jax_chunks(monkeypatch):
    """Buckets over BUCKET_BYTES_BUDGET are summed in row chunks, in
    both packages: the chunked plain version agrees with its unchunked
    self (``einsum`` may sum a chunk in another order) and the chunked
    JAX path."""
    src, dst, w, n_dst, n_src, kw = _graph("zipf")
    s, d, ww = _sorted(src, dst, w)
    x = np.random.default_rng(7).normal(size=(n_src, 16)).astype(np.float32)
    tm = t_ell.build_ell(s, d, ww, n_dst)
    whole = t_ell.ell_spmm_plain(tm, torch.from_numpy(x))
    budget = 1 << 15
    monkeypatch.setattr(t_ell, "BUCKET_BYTES_BUDGET", budget)
    monkeypatch.setattr(j_ell, "BUCKET_BYTES_BUDGET", budget)
    assert max(n * k for n, k in zip(tm.rows, tm.ks)) * 16 * 4 > budget
    chunked = t_ell.ell_spmm_plain(tm, torch.from_numpy(x))
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=RTOL,
                               atol=ATOL)
    want = np.asarray(j_ell.ell_spmm(j_ell.build_ell(s, d, ww, n_dst),
                                     jnp.asarray(x)))
    np.testing.assert_allclose(chunked.numpy(), want, rtol=RTOL, atol=ATOL)


def _both_graphs(name, with_pallas):
    src, dst, w, n_dst, n_src, _ = _graph(name)
    jg = j_build_graph(src, dst, w, n_dst, n_src, with_pallas=with_pallas)
    tg = build_graph(src, dst, w, n_dst, n_src, device="cpu",
                     with_pallas=with_pallas, impl="ell")
    return jg, tg


def _jax_out_and_grad(jg, x, cot, monkeypatch):
    monkeypatch.setattr(j_spmm_mod, "SPMM_IMPL", "ell")
    out = j_spmm_mod.spmm(jg, jnp.asarray(x))
    gx = jax.grad(lambda x_: jnp.sum(j_spmm_mod.spmm(jg, x_) * cot))(
        jnp.asarray(x))
    return np.asarray(out), np.asarray(gx)


@pytest.mark.parametrize("with_pallas", [False, True])
@pytest.mark.parametrize("name", ["zipf", "rect"])
def test_ell_spmm_function_matches_jax(monkeypatch, name, with_pallas):
    jg, tg = _both_graphs(name, with_pallas)
    assert tg.ell is not None and tg.rev_ell is not None
    for field in ("ell", "rev_ell"):     # built from the real edges
        for a, b in zip(getattr(jg, field).idxs, getattr(tg, field).idxs):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        for a, b in zip(getattr(jg, field).eposs, getattr(tg, field).eposs):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    rng = np.random.default_rng(8)
    x = rng.normal(size=(tg.n_src_nodes, 8)).astype(np.float32)
    cot = rng.normal(size=(tg.n_nodes, 8)).astype(np.float32)
    want, want_gx = _jax_out_and_grad(jg, x, cot, monkeypatch)
    xt = torch.from_numpy(x).requires_grad_()
    out = spmm(tg, xt)
    assert type(out.grad_fn).__name__ == "EllSpmmFunctionBackward"
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, rtol=RTOL, atol=ATOL)


def test_ell_weight_cotangent_matches_coo():
    """weight_grad=True: dL/dw[e] = x[src[e]]·g[dst[e]], as on the other
    paths."""
    _, tg = _both_graphs("zipf", True)
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=(tg.n_src_nodes, 4)).astype(
        np.float32))
    cot = torch.from_numpy(rng.normal(size=(tg.n_nodes, 4)).astype(
        np.float32))
    grads = []
    for impl in ("ell", "xla"):
        w = tg.weight.clone().requires_grad_()
        g = dataclasses.replace(tg, impl=impl, weight=w)
        (spmm(g, x, weight_grad=True) * cot).sum().backward()
        grads.append(w.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=RTOL, atol=ATOL)


def test_rebuild_ell_matches_jax_reweight(monkeypatch):
    """with_weight(rebuild_ell=True) on a pallas-padded graph re-weights
    both layouts from the real edges' weights, as the JAX package's
    ell_reweight does, and stays on ell."""
    jg, tg = _both_graphs("zipf", True)
    rng = np.random.default_rng(11)
    keep = (rng.random(tg.n_edges_padded) > 0.3).astype(np.float32)
    jg2 = jg.with_weight(jg.weight * jnp.asarray(keep), rebuild_ell=True)
    tg2 = tg.with_weight(tg.weight * torch.from_numpy(keep),
                         rebuild_ell=True)
    assert tg2.impl == "ell" and tg2.ell is not None
    for field in ("ell", "rev_ell"):
        for a, b in zip(getattr(jg2, field).ws, getattr(tg2, field).ws):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        ws = t_ell.reweight_ws(getattr(tg, field),
                               tg2.weight[:tg.n_edges])
        for a, b in zip(ws, getattr(tg2, field).ws):
            assert torch.equal(a, b)
    x = rng.normal(size=(tg.n_src_nodes, 8)).astype(np.float32)
    cot = rng.normal(size=(tg.n_nodes, 8)).astype(np.float32)
    want, want_gx = _jax_out_and_grad(jg2, x, cot, monkeypatch)
    xt = torch.from_numpy(x).requires_grad_()
    out = spmm(tg2, xt)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, rtol=RTOL, atol=ATOL)


def test_with_ws_refuses_other_shapes():
    _, tg = _both_graphs("zipf", False)
    ws = t_ell.reweight_ws(tg.ell, tg.weight)
    with pytest.raises(ValueError, match="with_ws"):
        t_ell.with_ws(tg.ell, ws[:-1])
    with pytest.raises(ValueError, match="with_epos"):
        t_ell.reweight_ws(dataclasses.replace(tg.ell, epos=None), tg.weight)


def test_reverse_swaps_layouts():
    _, tg = _both_graphs("rect", False)
    gr = tg.reverse()
    assert gr.ell is tg.rev_ell and gr.rev_ell is tg.ell
    assert gr.reverse().ell is tg.ell
    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=(tg.n_nodes, 4)).astype(np.float32))
    np.testing.assert_allclose(
        spmm(gr, x).numpy(),
        spmm(dataclasses.replace(gr, impl="xla"), x).numpy(),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("how", ["built_without", "with_weight",
                                 "no_reverse"])
def test_ell_graph_without_layouts_runs_xla(how):
    src, dst, w, n_dst, n_src, _ = _graph("zipf")
    if how == "built_without":
        g = build_graph(src, dst, w, n_dst, n_src, device="cpu", impl="ell",
                        with_ell=False)
    elif how == "with_weight":
        g0 = build_graph(src, dst, w, n_dst, n_src, device="cpu", impl="ell")
        g = g0.with_weight(g0.weight * 0.5)
        w = 0.5 * w
    else:
        g = build_graph(src, dst, w, n_dst, n_src, device="cpu", impl="ell",
                        with_reverse=False)
    assert g.ell is None and g.rev_ell is None
    xt = torch.from_numpy(np.random.default_rng(13).normal(
        size=(n_src, 4)).astype(np.float32)).requires_grad_()
    out = spmm(g, xt)
    if how != "no_reverse":
        assert type(out.grad_fn).__name__ == "CooSpmmFunctionBackward"
    oracle = np.zeros((n_dst, 4))
    np.add.at(oracle, dst, w.astype(np.float64)[:, None]
              * xt.detach().numpy()[src])
    np.testing.assert_allclose(out.detach().numpy(), oracle, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("impl,built", [("ell", True), ("xla", False),
                                        ("pallas", False)])
def test_dataset_builds_layouts_for_ell_only(impl, built):
    from conftest import base_config_dict
    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.quick_start import create_dataset
    c = Config(config_dict=base_config_dict(
        model="LightGCN", enable_sparse=True, sparse_spmm_impl=impl,
        use_gpu=False))
    g = create_dataset(c).get_norm_adj_graph(device="cpu")
    assert g.impl == impl and (g.ell is not None) == built
    assert (g.rev_ell is not None) == built


def test_wrapper_has_no_fallback_for_cuda():
    """A CUDA tensor launches the kernel or raises: no try around the
    build or launch, the plain version is reached only for CPU, and the
    kernel adds nothing atomically (reruns repeat bit for bit)."""
    src = inspect.getsource(t_ell.ell_spmm)
    assert "try:" not in src and "except" not in src
    assert src.index('x.device.type == "cpu"') < src.index("ell_spmm_plain(")
    assert src.count("ell_spmm_plain(") == 1
    for fn in (EllSpmmFunction.forward, EllSpmmFunction.backward):
        body = inspect.getsource(fn)
        assert "_plain(" not in body and "try:" not in body
    assert "ell_spmm_transpose(graph.rev_ell" in inspect.getsource(
        EllSpmmFunction.backward)
    cu = open(cuda_build.CSRC_DIR + "/ell_spmm.cu").read()
    assert "atomic" not in re.sub(r"//.*", "", cu)
    assert "replaces recbole_gnn_tpu/ops/ell_spmm.py" in cu.lower()


def test_layout_launch_args_are_made_once_and_follow_the_arrays():
    """The layout's kernel arguments (pointers, bucket table) are made at
    its first launch and reused; a re-weighted layout, or an array put in
    place of another, gets them anew."""
    _, tg = _both_graphs("zipf", False)
    m = tg.ell
    dev = torch.device("cpu")
    args = t_ell._layout_args(m, dev)
    assert t_ell._layout_args(m, dev) is args
    assert args[:3] == (m.idx.data_ptr(), m.w.data_ptr(), m.vdst.data_ptr())
    assert list(args[7][:len(m.ks)]) == list(m.ks) and args[9] == len(m.ks)
    m2 = t_ell.ell_reweight(m, tg.weight * 2)
    assert m2.launch is None
    assert t_ell._layout_args(m2, dev)[1] == m2.w.data_ptr() != args[1]
    m.w = m.w.clone()
    assert t_ell._layout_args(m, dev)[1] == m.w.data_ptr() != args[1]
    m.vdst = m.vdst.to(torch.int64)
    with pytest.raises(TypeError, match="vdst"):
        t_ell._layout_args(m, dev)


def test_wrapper_rejects_devices_without_kernel():
    _, tg = _both_graphs("zipf", False)
    with pytest.raises(ValueError, match="unsupported device"):
        t_ell.ell_spmm(tg.ell, torch.empty((tg.n_src_nodes, 4),
                                           device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build(["ell_spmm"])


def test_empty_graph():
    m = t_ell.build_ell(np.zeros(0, int), np.zeros(0, int), np.zeros(0),
                        5)
    assert m.ks == () and m.n_vrows == 0 and m.rest_node.tolist() == list(
        range(5))
    out = t_ell.ell_spmm(m, torch.ones(3, 4))
    assert out.shape == (5, 4) and not out.any()
