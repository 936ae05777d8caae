"""Port parity: the SpMM ops on a bf16 x (``activation_dtype: bfloat16``).

Each op's plain version (what its wrapper runs for CPU tensors, and what
``chip_smoke.py`` holds the CUDA kernel against on the card) on a bf16
x against the JAX function on the same inputs, made from a seed with
numpy: the output dtype must equal JAX's, and the values agree within
the bound each case states.

* ``ell_spmm`` (K2, bf16 out) and the ``pallas`` kernel (K1, f32 out, in
  interpret mode as ``tests/test_ops.py`` runs it, in f32x2, bf16 and
  packed): both sides sum in f32, so they differ by the output's one
  rounding and the order of f32 sums: ``|Δ| ≤ 2⁻⁷·Σ|w·x|`` elementwise.
* ``spmm_coo`` (the ``xla`` and CPU ``pallas`` SpMM, bf16 out): JAX sums
  its bf16 messages in bf16, so its sum drifts from the exact one as a
  row's terms pile up.  The bound is JAX's own error on the same
  inputs: its largest ``|JAX − exact| / Σ|terms|`` over the elements
  (exact: the f64 sum of the rounded terms; 1.1e-2 at mean degree 20,
  1.6e-2 with Zipf hubs of degree 1,509), asserted to stay below
  ``SPMM_COO_JAX_REL``.  The port's ``spmm_coo`` (bf16 sums too) and
  ``xla_spmm`` (D2 + D1's plain versions, f32 sums, one rounding) must
  sit within that bound of the exact sum, and within twice it of JAX.
* the dense form: f32 out for a bf16 x (the promoted type of JAX's
  ``jnp.dot(..., preferred_element_type=f32)``), for an f32 and a bf16
  ``a``; the old port narrowed an f32 ``a`` to bf16 and returned bf16.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.ops import ell_spmm as j_ell
from recbole_gnn_tpu.ops.pallas_spmm import build_pallas_meta, pallas_spmm
from recbole_gnn_tpu.ops.spmm import build_dense_bipartite as j_build_dense
from recbole_gnn_tpu.ops.spmm import spmm_coo as j_spmm_coo
from recbole_gnn_tpu.ops.spmm import spmm_dense_bipartite as j_spmm_dense
from recbole_gnn_tpu_torch.ops import cuda_build
from recbole_gnn_tpu_torch.ops import ell_spmm as t_ell
from recbole_gnn_tpu_torch.ops import gather as t_gather
from recbole_gnn_tpu_torch.ops import segment_spmm as t_seg
from recbole_gnn_tpu_torch.ops import segment_sum as t_sum
from recbole_gnn_tpu_torch.ops.spmm import (build_dense_bipartite,
                                            build_graph, spmm,
                                            spmm_dense_bipartite,
                                            spmm_dense_bipartite_dropout,
                                            xla_spmm)

BF16 = torch.bfloat16
# both sides sum in f32: one bf16 rounding of the output (2⁻⁹ of |out|
# ≤ Σ|terms|) plus f32 order, well inside
TOL_F32_SUMS = 2.0 ** -7
# JAX's spmm_coo against the exact sum of its rounded terms (measured on
# these inputs: up to 1.1e-2·Σ|terms| at mean degree 20, 1.6e-2 with the
# Zipf hubs)
SPMM_COO_JAX_REL = 2e-2


def _case(name):
    """(src, dst, w, x, n): a uniform graph at mean degree 20 and a
    Zipf-skewed one whose hub rows exceed K_CAP (split ELL rows)."""
    rng = np.random.default_rng({"uniform": 5, "hubs": 6}[name])
    n, e, d = 300, 6000, 64
    dst = (rng.integers(0, n, e) if name == "uniform"
           else (rng.zipf(1.3, e) - 1) % n)
    src = rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return src, dst, w, x, n


def _bf16_np(a):
    """f32 numpy rounded to bf16 (nearest even), as f32."""
    return torch.from_numpy(a).to(BF16).float().numpy()


def _exact(src, dst, w, x, n, round_w=True, round_terms=False):
    """Σ w·x in f64 over the bf16-rounded x (and w); with
    ``round_terms`` each product is rounded to bf16 first.  Also Σ|term|."""
    xb = _bf16_np(x).astype(np.float64)
    wb = (_bf16_np(w) if round_w else w).astype(np.float64)
    terms = wb[:, None] * xb[src]
    if round_terms:
        terms = _bf16_np(terms.astype(np.float32)).astype(np.float64)
    out = np.zeros((n, x.shape[1]))
    np.add.at(out, dst, terms)
    abssum = np.zeros_like(out)
    np.add.at(abssum, dst, np.abs(terms))
    return out, abssum


def _sorted(src, dst, w):
    o = np.argsort(dst, kind="stable")
    return src[o].astype(np.int32), dst[o], w[o]


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("name", ["uniform", "hubs"])
def test_ell_spmm_plain_bf16_matches_jax(name):
    src, dst, w, x, n = _case(name)
    s, d, ww = _sorted(src, dst, w)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = j_ell.ell_spmm(j_ell.build_ell(s, d, ww, n), xj)
    tm = t_ell.build_ell(s, d, ww, n)
    if name == "hubs":
        assert tm.n_multi > 0                  # split rows are summed too
    xt = torch.from_numpy(x).to(BF16)
    got = t_ell.ell_spmm(tm, xt)               # CPU: the plain version
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    exact, abssum = _exact(src, dst, w, x, n)
    err = np.abs(got.float().numpy() - _f32(want))
    assert (err <= TOL_F32_SUMS * abssum).all(), err.max()
    # the plain version rounds once: within one bf16 rounding of exact
    assert (np.abs(got.float().numpy() - exact)
            <= 2.0 ** -8 * np.abs(exact) + 1e-6 * abssum).all()
    pad_free = t_ell.ell_spmm_pad_free_plain(tm, xt)
    assert pad_free.dtype == BF16
    assert (np.abs(pad_free.float().numpy() - got.float().numpy())
            <= TOL_F32_SUMS * abssum).all()


@pytest.mark.parametrize("precision", ["f32x2", "bf16", "packed"])
@pytest.mark.parametrize("name", ["uniform", "hubs"])
def test_segment_spmm_plain_bf16_matches_pallas_interpret(name, precision):
    src, dst, w, x, n = _case(name)
    s, d_, w_ = t_seg.pad_edges(src, dst, w, n)
    meta = build_pallas_meta(d_, n)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = pallas_spmm(jnp.asarray(s), jnp.asarray(d_), jnp.asarray(w_), xj,
                       meta, precision=precision, interpret=True)[:n]
    t = torch.from_numpy
    # the kernel's plain version (the wrapper's CPU path in bf16 and
    # packed; in f32x2 the wrapper runs the JAX CPU path, spmm_coo)
    got = t_seg.segment_spmm_plain(t(s), t(d_), t(w_), t(x).to(BF16), n,
                                   precision)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    if precision != "f32x2":
        assert torch.equal(got, t_seg.segment_spmm(
            t(s), t(d_), t(w_), t(t_seg.build_rowptr(d_, n)),
            t(x).to(BF16), precision))
    # packed keeps the f32 weight; the others round it to bf16
    _, abssum = _exact(src, dst, w, x, n, round_w=precision != "packed")
    err = np.abs(got.numpy() - np.asarray(want))
    assert (err <= TOL_F32_SUMS * abssum).all(), err.max()
    exact, _ = _exact(src, dst, w, x, n, round_w=precision != "packed",
                      round_terms=precision == "bf16")
    # f32 sums of the same terms, far inside the bound (packed: each term
    # split into planes that keep it to ~2⁻¹⁶)
    rel = 1e-4 if precision == "packed" else 1e-5
    assert (np.abs(got.numpy() - exact) <= rel * abssum + 1e-7).all()


@pytest.mark.parametrize("name", ["uniform", "hubs"])
def test_spmm_coo_and_xla_bf16_within_jax_error(name):
    src, dst, w, x, n = _case(name)
    s, d_, ww = _sorted(src, dst, w)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = j_spmm_coo(jnp.asarray(s), jnp.asarray(d_), jnp.asarray(ww), xj, n)
    assert want.dtype == jnp.bfloat16
    exact, abssum = _exact(src, dst, w, x, n, round_terms=True)
    # JAX's own error: the bound
    jax_rel = (np.abs(_f32(want) - exact) / np.maximum(abssum, 1e-30)).max()
    assert 1e-3 < jax_rel <= SPMM_COO_JAX_REL, jax_rel
    bound = jax_rel * abssum + 1e-6
    g = build_graph(s, d_, ww, n, device="cpu", impl="xla")
    xt = torch.from_numpy(x).to(BF16)
    for what, got in (
            ("spmm_coo", t_seg.spmm_coo(g.src, g.dst, g.weight, xt, n)),
            ("xla_spmm", xla_spmm(g.src, g.dst, g.weight, g.rowptr, xt)),
            ("xla_spmm chunked", xla_spmm(g.src, g.dst, g.weight, g.rowptr,
                                          xt, chunk=1001))):
        assert got.dtype == BF16, what
        got = got.float().numpy()
        assert (np.abs(got - exact) <= bound).all(), what
        assert (np.abs(got - _f32(want)) <= 2 * bound).all(), what
    # D1's plain version sums in f32 and rounds once: one rounding from
    # exact without chunks
    one = xla_spmm(g.src, g.dst, g.weight, g.rowptr, xt).float().numpy()
    assert (np.abs(one - exact) <= 2.0 ** -8 * np.abs(exact)
            + 1e-6 * abssum).all()


def test_d2_and_d1_plain_versions_on_bf16_rows():
    src, dst, w, x, n = _case("uniform")
    g = build_graph(src, dst, w, n, device="cpu", impl="xla")
    xt = torch.from_numpy(x).to(BF16)
    rows = t_gather.row_gather(xt, g.src)
    assert rows.dtype == BF16
    assert torch.equal(rows, xt[g.src.long()])            # bit for bit
    got = t_sum.block_segment_sum(rows, g.dst, g.rowptr, "f32",
                                  weight=g.weight)
    shares = t_sum.block_segment_sum_shares_plain(rows, g.rowptr, "f32",
                                                  weight=g.weight,
                                                  share_edges=7)
    assert got.dtype == shares.dtype == BF16
    exact, abssum = _exact(src, dst, w, x, n, round_terms=True)
    for out in (got, shares):
        assert (np.abs(out.float().numpy() - exact)
                <= 2.0 ** -8 * np.abs(exact) + 1e-6 * abssum).all()
    # out=: bf16(out + Σ), rows without edges left as they were
    prev = torch.randn(n, x.shape[1]).to(BF16)
    acc = t_sum.block_segment_sum(rows, g.dst, g.rowptr, "f32",
                                  out=prev.clone(), weight=g.weight)
    want = prev.float().numpy() + exact
    assert acc.dtype == BF16
    assert (np.abs(acc.float().numpy() - want)
            <= 2.0 ** -8 * np.abs(want) + 1e-6 * abssum).all()
    # bf16 messages are summed with a weight in f32 mode only
    for mode, wt in (("bf16", None), ("f32", None)):
        with pytest.raises(ValueError, match="bf16 messages"):
            t_sum.block_segment_sum(rows, g.dst, g.rowptr, mode, weight=wt)


@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16])
def test_dense_product_promotes_like_jax(a_dtype):
    """f32 out for a bf16 x, as JAX's ``jnp.dot(a, x,
    preferred_element_type=f32)``; the port used to narrow an f32 ``a``
    to x's bf16 and return bf16 (this test failed on it)."""
    rng = np.random.default_rng(4)
    nu, ni, e, d = 30, 50, 200, 16
    users, items = rng.integers(0, nu, e), rng.integers(0, ni, e)
    w = rng.random(e).astype(np.float32)
    x = rng.normal(size=(nu + ni, d)).astype(np.float32)
    jdt = jnp.float32 if a_dtype == torch.float32 else jnp.bfloat16
    gj = j_build_dense(users, items, w, nu, ni, dtype=jdt)
    want = j_spmm_dense(gj, jnp.asarray(x).astype(jnp.bfloat16))
    gt = build_dense_bipartite(users, items, w, nu, ni, device="cpu",
                               dtype=a_dtype)
    xt = torch.from_numpy(x).to(BF16)
    got = spmm_dense_bipartite(gt, xt)
    assert want.dtype == jnp.float32
    assert got.dtype == torch.float32
    # the same exact products summed in f32: f32 order only
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    masks = (torch.ones(nu, ni, dtype=torch.bool),) * 2
    drop = spmm_dense_bipartite_dropout(gt, xt, masks)
    assert drop.dtype == torch.float32
    np.testing.assert_allclose(drop.numpy(), got.numpy(), rtol=1e-6)


@pytest.mark.parametrize("impl", ["ell", "xla", "pallas"])
def test_spmm_bf16_dtypes_and_gradient_follow_jax(impl):
    """The differentiable ``spmm`` on a bf16 x: the JAX output dtypes on
    the CPU (bf16 on every sparse impl: ``pallas`` off the TPU is
    ``spmm_coo``) and a bf16 cotangent for x."""
    src, dst, w, x, n = _case("uniform")
    g = build_graph(src, dst, w, n, device="cpu", impl=impl,
                    with_pallas=impl == "pallas")
    xt = torch.from_numpy(x).to(BF16).requires_grad_(True)
    y = spmm(g, xt)
    assert y.dtype == BF16
    y.float().sum().backward()
    assert xt.grad.dtype == BF16
    # the gradient of Σ out is Σ over each node's out-edges of bf16(w):
    # one rounding on ell and xla (f32 sums), JAX's spmm_coo error
    # bound on pallas (bf16 sums)
    wb = _bf16_np(w).astype(np.float64)
    deg_w, abs_w = np.zeros(n), np.zeros(n)
    np.add.at(deg_w, src, wb)
    np.add.at(abs_w, src, np.abs(wb))
    lim = (SPMM_COO_JAX_REL * abs_w if impl == "pallas"
           else 2.0 ** -8 * np.abs(deg_w) + 1e-6 * abs_w)
    assert (np.abs(xt.grad.float().numpy()[:, 0] - deg_w) <= lim).all()


def test_vec_width_counts_elements_of_the_row_type():
    """16-byte loads: 8 bf16 values or 4 floats where the row width and
    the address allow, narrower where they do not (a bf16 row at an odd
    offset of a concatenation: 2-byte loads)."""
    x = torch.zeros(10, 64)
    assert cuda_build.vec_width(x) == 4
    xb = torch.zeros(10, 64, dtype=BF16)
    assert cuda_build.vec_width(xb) == 8
    assert cuda_build.vec_width(xb[:, :60]) == 4        # width 60: 4 | 60
    flat = torch.zeros(1 + 10 * 64, dtype=BF16)
    assert cuda_build.vec_width(flat[1:].view(10, 64)) == 1
    assert cuda_build.vec_width(torch.zeros(10, 33, dtype=BF16)) == 1
    assert cuda_build.vec_width(torch.zeros(10, 6, dtype=BF16)) == 2


def test_kernel_wrappers_take_bf16_and_refuse_other_types():
    """Each CUDA entry reads f32 or bf16 x itself: the wrappers pass the
    tensor's pointer as it is (no upcast before the launch) and refuse
    other types before touching the card."""
    x16 = torch.zeros(4, 8, dtype=torch.float16)
    idx = torch.zeros(3, dtype=torch.int32)
    meta = t_ell.build_ell(np.array([0, 1]), np.array([0, 1]),
                           np.ones(2, np.float32), 2)
    assert cuda_build.ROW_DTYPES == (torch.float32, BF16)
    with pytest.raises(TypeError, match="ell_spmm"):
        t_ell._ell_spmm_cuda(meta, x16)
    with pytest.raises(TypeError, match="segment_spmm"):
        t_seg._segment_spmm_cuda(idx, idx, torch.zeros(3),
                                 torch.zeros(5, dtype=torch.int64), x16, 256)
    with pytest.raises(TypeError, match="block_segment_sum"):
        t_sum._check_cuda_args(x16, idx, torch.zeros(5, dtype=torch.int64),
                               None, None, "f32")
    for fn in (t_ell._ell_spmm_cuda, t_seg._check_cuda_args,
               t_sum._check_cuda_args, t_gather.row_gather):
        body = inspect.getsource(fn)
        assert "check_row_dtype(" in body
        assert ".float()" not in body and "to(torch.float32)" not in body
    for name in ("ell_spmm", "segment_spmm", "segment_sum"):
        text = open(f"{cuda_build.CSRC_DIR}/{name}.cu").read()
        assert "__nv_bfloat16" in text and '#include "rows.cuh"' in text
    assert "unsigned short" in open(
        f"{cuda_build.CSRC_DIR}/row_gather.cu").read()


def test_library_hash_covers_the_shared_header(monkeypatch, tmp_path):
    """An edited ``rows.cuh`` rebuilds every kernel that includes it."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    before = cuda_build.library_path("ell_spmm")
    with open(csrc / "rows.cuh", "a") as f:
        f.write("\n// edited\n")
    assert cuda_build.library_path("ell_spmm") != before
