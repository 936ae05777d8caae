"""Port parity: the segment SpMM (plain version on CPU tensors) against
the JAX package's Pallas streaming kernel in interpret mode and a
float64 oracle, its x- and weight-gradients (the transpose SpMM over
the reverse CSR) against the JAX custom VJP, plus the port's
graph-level dispatch rules.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds
it, forward and transpose, against the same plain version there.
"""

import dataclasses
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.ops.pallas_spmm import build_pallas_meta
from recbole_gnn_tpu.ops.pallas_spmm import pad_edges as j_pad_edges
from recbole_gnn_tpu.ops.pallas_spmm import pallas_spmm
from recbole_gnn_tpu.ops.pallas_spmm import segment_layout as j_segment_layout
from recbole_gnn_tpu.ops.spmm import build_dense_bipartite as j_build_dense
from recbole_gnn_tpu.ops.spmm import build_graph as j_build_graph
from recbole_gnn_tpu.ops.spmm import spmm as j_spmm
from recbole_gnn_tpu.ops.spmm import spmm_dense_bipartite as j_spmm_dense
from recbole_gnn_tpu_torch.ops import cuda_build, segment_spmm as seg_mod
from recbole_gnn_tpu_torch.ops.segment_spmm import (SegmentSpmmFunction,
                                                    build_rowptr, pad_edges,
                                                    segment_layout,
                                                    segment_spmm,
                                                    segment_spmm_transpose,
                                                    spmm_coo)
from recbole_gnn_tpu_torch.ops.spmm import (_check_cuda_impl, build_dense_bipartite,
                                            build_graph, spmm, spmm_any,
                                            spmm_dense_bipartite)

# The JAX kernel's f32x2 mode splits f32 into hi/lo bf16 passes (about
# 6e-5 absolute error against float64 on these shapes): test_ops.py's
# own tolerance.  The port's plain f32 index_add_ stays under 4e-6
# against float64 on them.
PALLAS_RTOL, PALLAS_ATOL = 2e-3, 2e-4
F64_RTOL, F64_ATOL = 1e-5, 1e-5


def _case(name):
    """(src, dst, w, n, d, layout kwargs) of the test_ops.py shapes plus
    an empty-rows case and D = 48."""
    if name == "interpret":             # test_ops: default layout
        rng = np.random.default_rng(11)
        n, e, d, lay = 300, 5000, 64, {}
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    elif name == "multisegment":        # several segments, split hubs
        rng = np.random.default_rng(21)
        n, e, d = 100, 1000, 64
        dst = (rng.zipf(1.3, size=e) % n).astype(np.int64)
        src = rng.integers(0, n, e)
        lay = {"ec": 64, "seg_max": 256, "bm": 32}
    elif name == "overrun":             # block overrun, 2 segments
        rng = np.random.default_rng(5)
        n, e, d, lay = 1000, 5000, 64, {"seg_max": 4096}
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    elif name == "empty_rows":          # odd rows, row 0 and the top empty
        rng = np.random.default_rng(31)
        n, e, d, lay = 400, 3000, 64, {"ec": 256, "seg_max": 1024}
        src, dst = rng.integers(0, n, e), 2 * rng.integers(1, n // 4, e)
    else:                               # d48
        rng = np.random.default_rng(41)
        n, e, d, lay = 300, 5000, 48, {}
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return src, dst, w, x, n, lay


CASES = ["interpret", "multisegment", "overrun", "empty_rows", "d48"]


def _oracle(src, dst, w, x, n):
    out = np.zeros((n, x.shape[1]), np.float64)
    np.add.at(out, dst, w.astype(np.float64)[:, None] * x[src].astype(np.float64))
    return out


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_pallas_interpret_and_f64(name):
    src, dst, w, x, n, lay = _case(name)
    ec, seg_max = lay.get("ec"), lay.get("seg_max")
    s, d_, w_ = pad_edges(src, dst, w, n, ec=ec, seg_max=seg_max)
    # the port's host padding is the JAX package's, element for element
    for a, b in zip((s, d_, w_), j_pad_edges(src, dst, w, n, ec=ec,
                                             seg_max=seg_max)):
        np.testing.assert_array_equal(a, b)
    meta = build_pallas_meta(d_, n, bm=lay.get("bm"), ec=ec, seg_max=seg_max)
    want = np.asarray(pallas_spmm(jnp.asarray(s), jnp.asarray(d_),
                                  jnp.asarray(w_), jnp.asarray(x), meta,
                                  interpret=True))[:n]
    rowptr = torch.from_numpy(build_rowptr(d_, n))
    before = segment_spmm.launches
    got = segment_spmm(torch.from_numpy(s), torch.from_numpy(d_),
                       torch.from_numpy(w_), rowptr, torch.from_numpy(x))
    assert segment_spmm.launches == before      # CPU: no kernel launch
    assert got.shape == (n, x.shape[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=PALLAS_RTOL,
                               atol=PALLAS_ATOL)
    oracle = _oracle(src, dst, w, x, n)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=F64_RTOL,
                               atol=F64_ATOL)
    if name == "empty_rows":
        empty = np.bincount(dst, minlength=n) == 0
        assert empty[0] and empty.sum() > n // 2
        assert not got.numpy()[empty].any()


@pytest.mark.parametrize("e", [0, 1, 4095, 4096, 4097, (1 << 20) + 1,
                               3 * (1 << 20) + 17])
def test_segment_layout_matches_jax(e):
    assert segment_layout(e) == j_segment_layout(e)
    n_seg, seg = segment_layout(e)
    assert n_seg * seg >= e and seg % 4096 == 0


def test_spmm_coo_chunked_equals_unchunked(monkeypatch):
    rng = np.random.default_rng(3)
    n, e, d = 50, 700, 8
    src = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    dst = torch.from_numpy(np.sort(rng.integers(0, n, e)).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=e).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    whole = spmm_coo(src, dst, w, x, n)
    monkeypatch.setattr(seg_mod, "MSGS_BYTES_BUDGET", 2 * d * 4 * 64)
    chunked = spmm_coo(src, dst, w, x, n)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("impl", ["ell", "xla", "pallas"])
@pytest.mark.parametrize("precision", ["packed", "f32x2", "bf16"])
def test_graph_spmm_cpu_runs_plain_for_every_impl(impl, precision):
    src, dst, w, x, n, _ = _case("interpret")
    g = build_graph(src, dst, w, n, device="cpu", with_pallas=True,
                    impl=impl, precision=precision)
    got = spmm(g, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _oracle(src, dst, w, x, n),
                               rtol=F64_RTOL, atol=F64_ATOL)


@pytest.mark.parametrize("impl,precision,match", [
    ("ell", "f32x2", "K2"), ("ell", "bf16", "K2"),
    ("pallas", "packed", "f32x2"), ("pallas", "bf16", "f32x2")])
def test_cuda_dispatch_refuses_unported_impls(impl, precision, match):
    """On a CUDA tensor impl=pallas runs (the kernel) only with
    precision=f32x2, and impl=ell (K2, not ported) raises, instead of
    falling back."""
    g = build_graph(np.array([0]), np.array([1]), np.array([1.0]), 2,
                    device="cpu", impl=impl, precision=precision)
    with pytest.raises(NotImplementedError, match=match):
        _check_cuda_impl(g)
    _check_cuda_impl(build_graph(np.array([0]), np.array([1]),
                                 np.array([1.0]), 2, device="cpu"))


@pytest.mark.parametrize("precision", ["packed", "f32x2", "bf16"])
def test_cuda_dispatch_accepts_xla_under_every_precision(precision):
    """impl=xla runs its kernels (D2 + D1) on the card whatever
    pallas_spmm_precision says: the JAX package reads the precision
    only on the Pallas path."""
    g = build_graph(np.array([0]), np.array([1]), np.array([1.0]), 2,
                    device="cpu", impl="xla", precision=precision)
    _check_cuda_impl(g)


def test_wrapper_rejects_devices_without_kernel():
    x = torch.empty((4, 8), device="meta")
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        segment_spmm(idx, idx, torch.zeros(3), torch.zeros(5, dtype=torch.int64), x)


def test_wrapper_has_no_fallback_for_cuda():
    """A CUDA tensor launches the kernel or raises: no try around the
    build or launch, and the plain version is reached only for CPU."""
    import inspect
    src = inspect.getsource(seg_mod.segment_spmm)
    assert "try:" not in src and "except" not in src
    assert src.index('x.device.type == "cpu"') < src.index("spmm_coo(")
    assert src.count("spmm_coo(") == 1
    cu = open(cuda_build.CSRC_DIR + "/segment_spmm.cu").read()
    assert "atomic" not in re.sub(r"//.*", "", cu)   # deterministic


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build(["segment_spmm"])


def test_library_path_keyed_by_source_hash():
    p = cuda_build.library_path("segment_spmm")
    assert p.startswith(cuda_build.BUILD_DIR)
    assert re.search(r"libsegment_spmm-[0-9a-f]{16}\.so$", p)
    assert p == cuda_build.library_path("segment_spmm")


def test_build_graph_validates_and_sorts():
    with pytest.raises(ValueError, match="out of range"):
        build_graph(np.array([0, 5]), np.array([1, 1]), np.ones(2), 3,
                    device="cpu")
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, 20, 100), rng.integers(0, 20, 100)
    g = build_graph(src, dst, rng.normal(size=100), 20, device="cpu")
    assert g.n_edges == g.n_edges_padded == 100
    assert np.all(np.diff(g.dst.numpy()) >= 0)
    assert np.all(np.diff(g.rev_dst.numpy()) >= 0)
    # rev_edge_id maps the transposed list back onto the forward one
    rid = g.rev_edge_id.numpy()
    np.testing.assert_array_equal(g.rev_src.numpy(), g.dst.numpy()[rid])
    np.testing.assert_array_equal(g.rev_weight.numpy(), g.weight.numpy()[rid])


def test_dense_bipartite_matches_jax():
    rng = np.random.default_rng(4)
    nu, ni, e, d = 30, 50, 200, 16
    users, items = rng.integers(0, nu, e), rng.integers(0, ni, e)
    w = rng.random(e).astype(np.float32)
    x = rng.normal(size=(nu + ni, d)).astype(np.float32)
    gt = build_dense_bipartite(users, items, w, nu, ni, device="cpu")
    gj = j_build_dense(users, items, w, nu, ni)
    want = np.asarray(j_spmm_dense(gj, jnp.asarray(x)))
    got = spmm_any(gt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    gb = build_dense_bipartite(users, items, w, nu, ni, device="cpu",
                               dtype=torch.bfloat16)
    got_b = spmm_dense_bipartite(gb, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_b, want, rtol=2e-2, atol=2e-2)
    assert jax.default_backend() == "cpu"


# -- gradients: the transpose SpMM (K1ᵀ) -----------------------------------

def _grad_case(name):
    """(src, dst, w, x, cot, n_dst, n_src): the forward CASES, plus a
    rectangular bipartite graph (n_dst != n_src: the transpose swaps the
    row counts) and an E > 2²⁰ graph."""
    if name == "rectangular":
        rng = np.random.default_rng(51)
        n_dst, n_src, e, d = 300, 170, 6000, 64
        src, dst = rng.integers(0, n_src, e), rng.integers(1, n_dst, e)
        w = rng.normal(size=e).astype(np.float32)
    elif name == "e_above_2p20":
        rng = np.random.default_rng(61)
        n_dst = n_src = 200_000        # short rows, as in the forward
        e, d = (1 << 20) + 4099, 8     # cases: f32 sums of ~5 terms
        src, dst = rng.integers(0, n_src, e), rng.integers(0, n_dst, e)
        w = rng.normal(size=e).astype(np.float32)
    else:
        src, dst, w, x, n_dst, _ = _case(name)
        n_src, d = n_dst, x.shape[1]
        rng = np.random.default_rng(71)
    x = rng.normal(size=(n_src, d)).astype(np.float32)
    cot = rng.normal(size=(n_dst, d)).astype(np.float32)
    return src, dst, w, x, cot, n_dst, n_src


def _port_grads(g, x, cot, weight_grad=False):
    """(out, x-grad, weight-grad) of sum(spmm(g, x) * cot) in the port."""
    xt = torch.from_numpy(x).requires_grad_()
    if weight_grad:
        g = dataclasses.replace(g, weight=g.weight.clone().requires_grad_())
    out = spmm(g, xt, weight_grad=weight_grad)
    assert type(out.grad_fn).__name__ == "SegmentSpmmFunctionBackward"
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy(), (
        g.weight.grad.numpy() if weight_grad else None)


GRAD_CASES = CASES + ["rectangular"]


@pytest.mark.parametrize("name", GRAD_CASES)
def test_x_grad_matches_jax_vjp_pallas_interpret_and_f64(name):
    src, dst, w, x, cot, n_dst, n_src = _grad_case(name)
    gj = j_build_graph(src, dst, w, n_dst, n_src, with_pallas=True,
                       with_ell=False)
    gt = build_graph(src, dst, w, n_dst, n_src, device="cpu",
                     with_pallas=True)
    # the reverse arrays equal the JAX Graph's element for element
    for a in ("src", "dst", "weight", "rev_src", "rev_dst", "rev_edge_id",
              "rev_weight"):
        np.testing.assert_array_equal(getattr(gt, a).numpy(),
                                      np.asarray(getattr(gj, a)), err_msg=a)
    np.testing.assert_array_equal(
        gt.rev_rowptr.numpy(),
        np.searchsorted(gt.rev_dst.numpy(), np.arange(n_src + 1)))
    before = (segment_spmm.launches, segment_spmm_transpose.launches)
    out, gx, _ = _port_grads(gt, x, cot)
    assert (segment_spmm.launches,
            segment_spmm_transpose.launches) == before   # CPU: no kernel
    assert out.shape == (n_dst, x.shape[1]) and gx.shape == x.shape
    # the JAX custom VJP (its XLA transpose over the same reverse arrays)
    want = np.asarray(jax.grad(
        lambda x_: jnp.sum(j_spmm(gj, x_) * cot))(jnp.asarray(x)))
    np.testing.assert_allclose(gx, want, rtol=1e-5, atol=1e-5)
    # the Pallas kernel in interpret mode, called as _spmm_core_bwd does
    kern = np.asarray(pallas_spmm(gj.rev_src, gj.rev_dst, gj.rev_weight,
                                  jnp.asarray(cot), gj.rev_block_ptr,
                                  interpret=True))[:n_src]
    np.testing.assert_allclose(gx, kern, rtol=PALLAS_RTOL, atol=PALLAS_ATOL)
    np.testing.assert_allclose(gx, _oracle(dst, src, w, cot, n_src),
                               rtol=F64_RTOL, atol=F64_ATOL)


def test_x_grad_above_2p20_edges_matches_f64():
    src, dst, w, x, cot, n_dst, n_src = _grad_case("e_above_2p20")
    gt = build_graph(src, dst, w, n_dst, n_src, device="cpu",
                     with_pallas=True)
    assert gt.n_edges_padded > 1 << 20
    _, gx, _ = _port_grads(gt, x, cot)
    np.testing.assert_allclose(gx, _oracle(dst, src, w, cot, n_src),
                               rtol=F64_RTOL, atol=F64_ATOL)


@pytest.mark.parametrize("name", ["interpret", "rectangular"])
def test_weight_grad_matches_jax(name):
    src, dst, w, x, cot, n_dst, n_src = _grad_case(name)
    gj = j_build_graph(src, dst, w, n_dst, n_src, with_pallas=True,
                       with_ell=False)
    gt = build_graph(src, dst, w, n_dst, n_src, device="cpu",
                     with_pallas=True)
    _, gx, gw = _port_grads(gt, x, cot, weight_grad=True)
    want = np.asarray(jax.grad(lambda w_: jnp.sum(
        j_spmm(gj.with_weight(w_), jnp.asarray(x), weight_grad=True)
        * cot))(gj.weight))
    assert gw.shape == (gt.n_edges_padded,)
    np.testing.assert_allclose(gw, want, rtol=1e-5, atol=1e-5)
    # default weight_grad=False: no weight cotangent at all
    wt = gt.weight.clone().requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    (spmm(dataclasses.replace(gt, weight=wt), xt) * torch.from_numpy(cot)
     ).sum().backward()
    assert wt.grad is None and xt.grad is not None


def test_reverse_matches_jax_and_transposes():
    src, dst, w, x, cot, n_dst, n_src = _grad_case("rectangular")
    gj = j_build_graph(src, dst, w, n_dst, n_src, with_pallas=True,
                       with_ell=False).reverse()
    gt = build_graph(src, dst, w, n_dst, n_src, device="cpu",
                     with_pallas=True).reverse()
    assert (gt.n_nodes, gt.n_src_nodes) == (n_src, n_dst)
    for a in ("src", "dst", "weight", "rev_src", "rev_dst", "rev_edge_id",
              "rev_weight"):
        np.testing.assert_array_equal(getattr(gt, a).numpy(),
                                      np.asarray(getattr(gj, a)), err_msg=a)
    # forward of the transpose = the x-gradient of the original
    got = spmm(gt, torch.from_numpy(cot)).numpy()
    np.testing.assert_allclose(got, _oracle(dst, src, w, cot, n_src),
                               rtol=F64_RTOL, atol=F64_ATOL)
    np.testing.assert_array_equal(gt.reverse().rowptr.numpy(),
                                  gt.rev_rowptr.numpy())
    with pytest.raises(ValueError, match="without reverse"):
        build_graph(src, dst, w, n_dst, n_src, device="cpu",
                    with_reverse=False).reverse()


def test_graph_without_reverse_differentiates_plain_on_cpu():
    src, dst, w, x, cot, n_dst, n_src = _grad_case("rectangular")
    g = build_graph(src, dst, w, n_dst, n_src, device="cpu",
                    with_reverse=False)
    xt = torch.from_numpy(x).requires_grad_()
    out = spmm(g, xt)
    assert type(out.grad_fn).__name__ != "SegmentSpmmFunctionBackward"
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(),
                               _oracle(dst, src, w, cot, n_src),
                               rtol=F64_RTOL, atol=F64_ATOL)


def test_transpose_has_no_fallback_for_cuda():
    """The backward reaches the plain version only through
    segment_spmm's CPU branch; a graph without the reverse ordering
    raises on the card instead of differentiating spmm_coo there."""
    bwd = inspect.getsource(SegmentSpmmFunction.backward)
    tr = inspect.getsource(segment_spmm_transpose)
    for src in (bwd, tr):
        assert "try:" not in src and "spmm_coo(" not in src
    assert "segment_spmm_transpose(" in bwd and "rev_rowptr" in bwd
    sp = inspect.getsource(spmm)
    assert sp.index("if not cuda:") < sp.index("spmm_coo(")
    assert sp.index("raise ValueError(") < sp.index("segment_spmm(")
    assert "with_reverse=True" in sp and "try:" not in sp
