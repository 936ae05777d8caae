"""Port parity: ``sparse_spmm_impl: xla`` — the row gather (D2) and the
block segment sum (D1) composed as the JAX package's ``spmm_coo`` /
``_spmm_coo_chunked`` and its custom VJP.

On the CPU an ``xla`` graph runs the composition through the plain
versions of both kernels, so these tests reach the chunk boundaries and
the clamped row pointers that the card runs.  The CUDA kernels run only
on the card; ``chip_smoke.py`` holds them against the same plain
versions there.  Tolerance: rtol/atol 1e-5 (the same f32 sums in
another order).
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

from recbole_gnn_tpu.ops.spmm import build_graph as j_build_graph
from recbole_gnn_tpu_torch.ops import cuda_build
from recbole_gnn_tpu_torch.ops import gather as gather_mod
from recbole_gnn_tpu_torch.ops import segment_spmm as seg_mod
from recbole_gnn_tpu_torch.ops import segment_sum as sum_mod
from recbole_gnn_tpu_torch.ops.gather import row_gather
from recbole_gnn_tpu_torch.ops.segment_spmm import build_rowptr
from recbole_gnn_tpu_torch.ops.segment_sum import block_segment_sum
from recbole_gnn_tpu_torch.ops.spmm import (CooSpmmFunction, build_graph,
                                            spmm, xla_spmm)
from test_torch_spmm import CASES, _grad_case, _oracle

# by module path: both ops packages re-export a function named spmm
j_spmm_mod = importlib.import_module("recbole_gnn_tpu.ops.spmm")
spmm_mod = importlib.import_module("recbole_gnn_tpu_torch.ops.spmm")

RTOL = ATOL = 1e-5
XLA_CASES = CASES + ["rectangular", "e_above_2p20"]


def _graphs(name, **kw):
    src, dst, w, x, cot, n_dst, n_src = _grad_case(name)
    gj = j_build_graph(src, dst, w, n_dst, n_src, with_pallas=True,
                       with_ell=False)
    gt = build_graph(src, dst, w, n_dst, n_src, device="cpu",
                     with_pallas=True, impl="xla", **kw)
    return gj, gt, x, cot


def _launches():
    return (row_gather.launches, block_segment_sum.launches)


@pytest.mark.parametrize("name", XLA_CASES)
def test_forward_matches_jax_spmm_coo(name):
    gj, gt, x, _ = _graphs(name)
    before = _launches()
    got = spmm(gt, torch.from_numpy(x)).numpy()
    assert _launches() == before                  # CPU: no kernel launch
    want = np.asarray(j_spmm_mod.spmm_coo(gj.src, gj.dst, gj.weight,
                                          jnp.asarray(x), gj.n_nodes))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if name == "empty_rows":
        empty = (gt.rowptr[1:] == gt.rowptr[:-1]).numpy()
        assert empty.sum() > gt.n_nodes // 2 and not got[empty].any()


@pytest.mark.parametrize("chunk", [1, 7, 300, 2048, 4999, 5000, 70_000])
def test_chunked_forward_matches_jax_chunked(chunk):
    """Chunks of ``chunk`` edges, boundaries inside rows, against JAX's
    ``_spmm_coo_chunked`` with the same chunk (weight-0 padding onto
    the last node)."""
    src, dst, w, x, n, _ = importlib.import_module(
        "test_torch_spmm")._case("multisegment")
    gj = j_build_graph(src, dst, w, n, with_pallas=True, with_ell=False)
    gt = build_graph(src, dst, w, n, device="cpu", with_pallas=True,
                     impl="xla")
    rp = gt.rowptr.numpy()
    # a boundary at a multiple of chunk falls strictly inside some row
    cuts = np.arange(chunk, gt.n_edges_padded, chunk)
    inside = np.isin(cuts, rp, invert=True)
    assert chunk >= gt.n_edges_padded or inside.any()
    got = xla_spmm(gt.src, gt.dst, gt.weight, gt.rowptr,
                   torch.from_numpy(x), chunk=chunk).numpy()
    want = np.asarray(j_spmm_mod._spmm_coo_chunked(
        gj.src, gj.dst, gj.weight, jnp.asarray(x), n, True, chunk=chunk))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _oracle(src, dst, w, x, n), rtol=RTOL,
                               atol=ATOL)


def test_budget_splits_into_chunks(monkeypatch):
    """Above MSGS_BYTES_BUDGET the forward and the backward run over
    edge chunks of budget / (2·D·4) edges, as JAX does."""
    gj, gt, x, cot = _graphs("interpret")
    d = x.shape[1]
    monkeypatch.setattr(seg_mod, "MSGS_BYTES_BUDGET", 2 * d * 4 * 1000)
    calls = []
    real = sum_mod.block_segment_sum_plain

    def spy(msgs, *a, **k):
        calls.append(msgs.shape[0])
        return real(msgs, *a, **k)

    monkeypatch.setattr(sum_mod, "block_segment_sum_plain", spy)
    xt = torch.from_numpy(x).requires_grad_()
    out = spmm(gt, xt)
    (out * torch.from_numpy(cot)).sum().backward()
    e = gt.n_edges_padded
    per_pass = [1000] * (e // 1000) + ([e % 1000] if e % 1000 else [])
    assert calls == per_pass * 2
    want = np.asarray(jax.grad(lambda x_: jnp.sum(
        j_spmm_mod._spmm_core((False, False, False), gj, x_) * cot))(
            jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.detach().numpy(),
                               _oracle(*_grad_case("interpret")[:3], x,
                                       gt.n_nodes), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", CASES + ["rectangular"])
def test_x_grad_matches_jax_custom_vjp(name):
    gj, gt, x, cot = _graphs(name)
    xt = torch.from_numpy(x).requires_grad_()
    out = spmm(gt, xt)
    assert type(out.grad_fn).__name__ == "CooSpmmFunctionBackward"
    before = _launches()
    (out * torch.from_numpy(cot)).sum().backward()
    assert _launches() == before
    want = np.asarray(jax.grad(lambda x_: jnp.sum(
        j_spmm_mod._spmm_core((False, False, False), gj, x_) * cot))(
            jnp.asarray(x)))
    assert xt.grad.shape == x.shape
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["interpret", "rectangular"])
def test_weight_grad_matches_jax(name):
    gj, gt, x, cot = _graphs(name)
    wt = gt.weight.clone().requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    (spmm(dataclasses.replace(gt, weight=wt), xt, weight_grad=True)
     * torch.from_numpy(cot)).sum().backward()
    want_w, want_x = jax.grad(lambda w_, x_: jnp.sum(j_spmm_mod._spmm_core(
        (False, False, True), gj.with_weight(w_), x_) * cot),
        argnums=(0, 1))(gj.weight, jnp.asarray(x))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_w),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x),
                               rtol=RTOL, atol=ATOL)
    # default weight_grad=False: no weight cotangent at all
    wt2 = gt.weight.clone().requires_grad_()
    (spmm(dataclasses.replace(gt, weight=wt2), torch.from_numpy(x)
          .requires_grad_()) * torch.from_numpy(cot)).sum().backward()
    assert wt2.grad is None


@pytest.mark.parametrize("with_rev", [False, True])
@pytest.mark.parametrize("name", ["interpret", "rectangular"])
def test_with_weight_matches_jax(name, with_rev):
    """A re-weighted graph: without ``rev_weight`` the backward gathers
    ``weight[rev_edge_id]`` per call, as JAX does; with it, uses it."""
    gj, gt, x, cot = _graphs(name)
    rng = np.random.default_rng(7)
    w2 = (rng.random(gt.n_edges_padded) < 0.7).astype(np.float32) * \
        gt.weight.numpy()
    rid = gt.rev_edge_id.numpy()
    rw2 = torch.from_numpy(w2[rid]) if with_rev else None
    g2 = gt.with_weight(torch.from_numpy(w2), rw2)
    assert g2.impl == "xla" and (g2.rev_weight is None) != with_rev
    xt = torch.from_numpy(x).requires_grad_()
    out = spmm(g2, xt)
    (out * torch.from_numpy(cot)).sum().backward()
    gj2 = gj.with_weight(jnp.asarray(w2),
                         None if rw2 is None else jnp.asarray(w2[rid]))
    want_out = np.asarray(j_spmm_mod.spmm(gj2, jnp.asarray(x)))
    want_gx = np.asarray(jax.grad(lambda x_: jnp.sum(
        j_spmm_mod.spmm(gj2, x_) * cot))(jnp.asarray(x)))
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, rtol=RTOL,
                               atol=ATOL)
    # the transposed view of a re-weighted graph carries the new weights
    gr = g2.reverse()
    np.testing.assert_array_equal(gr.weight.numpy(), w2[rid])
    np.testing.assert_allclose(spmm(gr, torch.from_numpy(cot)).numpy(),
                               want_gx, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl,want", [("ell", "xla"), ("xla", "xla"),
                                       ("pallas", "pallas")])
def test_with_weight_moves_ell_to_the_segment_sum_path(impl, want):
    """JAX's with_weight clears the baked ELL layouts, so a re-weighted
    ell graph runs the xla path; pallas keeps its kernel."""
    g = build_graph(np.array([0, 1]), np.array([1, 0]), np.ones(2), 2,
                    device="cpu", impl=impl)
    g2 = g.with_weight(torch.full((2,), 0.5))
    assert (g.impl, g2.impl) == (impl, want)
    assert g2.rev_weight is None and g2.rev_src is g.rev_src


def test_pallas_backward_gathers_reverse_weight_after_with_weight():
    gj, gt, x, cot = _graphs("rectangular")
    g2 = dataclasses.replace(gt, impl="pallas").with_weight(gt.weight * 0.5)
    xt = torch.from_numpy(x).requires_grad_()
    (spmm(g2, xt) * torch.from_numpy(cot)).sum().backward()
    src, dst, w, *_ = _grad_case("rectangular")
    np.testing.assert_allclose(
        xt.grad.numpy(), _oracle(dst, src, 0.5 * w, cot, gt.n_src_nodes),
        rtol=RTOL, atol=ATOL)


def test_graph_without_reverse_differentiates_plain_on_cpu():
    src, dst, w, x, cot, n_dst, n_src = _grad_case("rectangular")
    g = build_graph(src, dst, w, n_dst, n_src, device="cpu",
                    with_reverse=False, impl="xla")
    xt = torch.from_numpy(x).requires_grad_()
    out = spmm(g, xt)
    assert type(out.grad_fn).__name__ != "CooSpmmFunctionBackward"
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(),
                               _oracle(dst, src, w, cot, n_src),
                               rtol=RTOL, atol=ATOL)


def test_empty_edge_list():
    x = torch.ones(4, 3)
    rp = torch.zeros(6, dtype=torch.int64)
    e = torch.zeros(0, dtype=torch.int32)
    out = xla_spmm(e, e, torch.zeros(0), rp, x)
    assert out.shape == (5, 3) and not out.any()


def test_wrappers_have_no_fallback_for_cuda():
    """A CUDA tensor launches the kernel or raises: no try around the
    build or launch, and the plain version is reached only for CPU."""
    for fn, cpu_test, plain in (
            (gather_mod.row_gather, 'x.device.type == "cpu"',
             "row_gather_plain("),
            (sum_mod.block_segment_sum, 'msgs.device.type == "cpu"',
             "block_segment_sum_plain(")):
        src = inspect.getsource(fn)
        assert "try:" not in src and "except" not in src
        assert src.index(cpu_test) < src.index(plain)
        assert src.count(plain) == 1
    for fn in (xla_spmm, CooSpmmFunction.backward, spmm):
        src = inspect.getsource(fn)
        assert "try:" not in src and "_plain(" not in src
    bwd = inspect.getsource(CooSpmmFunction.backward)
    assert "spmm_coo(" not in bwd and "rev_rowptr" in bwd
    sp = inspect.getsource(spmm_mod._check_cuda_impl)
    assert "SPMM_IMPLS" in sp and '"xla"' not in sp and '"ell"' not in sp


@pytest.mark.parametrize("name", ["row_gather", "segment_sum"])
def test_cuda_sources_have_no_atomics(name):
    cu = open(f"{cuda_build.CSRC_DIR}/{name}.cu").read()
    assert "atomic" not in re.sub(r"//.*", "", cu)   # deterministic
    assert "sm_90a" in " ".join(cuda_build.NVCC_FLAGS)


@pytest.mark.parametrize("name", ["row_gather", "segment_sum"])
def test_build_without_nvcc_raises(monkeypatch, tmp_path, name):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build([name])


def test_wrappers_reject_devices_without_kernel():
    x = torch.empty((4, 8), device="meta")
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        row_gather(x, idx)
    with pytest.raises(ValueError, match="unsupported device"):
        block_segment_sum(torch.empty((3, 8), device="meta"), idx,
                          torch.zeros(5, dtype=torch.int64))


def test_row_gather_plain_equals_index_select():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(50, 33)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 50, 400).astype(np.int32))
    assert torch.equal(row_gather(x, idx), x[idx.long()])
    assert row_gather(x, idx[:0]).shape == (0, 33)


def test_rowptr_of_padded_graph_spans_every_edge():
    """block_segment_sum reads block ranges off the row pointer: it must
    run from 0 to E_pad, the padding on the last row."""
    gj, gt, _, _ = _graphs("overrun")
    rp = gt.rowptr.numpy()
    assert rp[0] == 0 and rp[-1] == gt.n_edges_padded
    np.testing.assert_array_equal(rp, build_rowptr(gt.dst.numpy(),
                                                   gt.n_nodes))
