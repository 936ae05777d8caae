"""Port parity: D1's share schedule and its edge weight.

The block segment sum kernel (``csrc/segment_sum.cu``) runs f32, bf16
and hilo on equal edge shares with ordered carries, the schedule of K1;
:func:`block_segment_sum_shares_plain` is that schedule in plain torch.
Here it is held against the wrapper's plain version and a float64
oracle on the share tests' graphs (a row with 60 % of the edges, rows
and empty rows on share boundaries, one row, a transposed rectangular
graph), at several share sizes, with the edge weight that the ``xla``
path now sums inside D1, with ``rowptr[0] != 0`` and accumulating.  The
``xla`` SpMM built on it is held against the JAX package's
``spmm_coo`` and ``_spmm_coo_chunked`` on the same graphs.

Tolerance: the f32 sums of the same terms in another order, within
1e-6 · Σ|terms| + 1e-5 (as the K1 share tests); the weighted sum
against the unweighted sum of pre-weighted messages bit for bit (one
rounded product per term, the same order).
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.ops.spmm import build_graph as j_build_graph
from recbole_gnn_tpu_torch.diag import pallas_floor as d1_probe
from recbole_gnn_tpu_torch.ops import segment_sum as sum_mod
from recbole_gnn_tpu_torch.ops.segment_spmm import (build_rowptr, pad_edges,
                                                    share_schedule)
from recbole_gnn_tpu_torch.ops.segment_sum import (
    SHARE_EDGES, block_segment_sum, block_segment_sum_plain,
    block_segment_sum_shares_plain)
from recbole_gnn_tpu_torch.ops.spmm import build_graph, spmm, xla_spmm
from test_torch_spmm import (F64_ATOL, SHARE_CASES, SHARE_SUM_RTOL,
                             _assert_close_abssum, _oracle, _share_case)

j_spmm_mod = importlib.import_module("recbole_gnn_tpu.ops.spmm")

SHARE_SIZES = sorted({1, 7, 32, SHARE_EDGES, 1 << 20})   # 2^20 > E


def _edges(name):
    """(msgs, dst, weight, rowptr, src, dst_raw, w, x, n): the padded,
    dst-sorted messages ``x[src]`` of a share test graph (over the
    reverse CSR for rev_rectangular), their weights and row pointer,
    and the raw edges for the float64 oracle."""
    src, dst, w, x, n, n_src, lay = _share_case(name)
    if name == "rev_rectangular":
        g = build_graph(dst, src, w, n_src, n, device="cpu",
                        with_pallas=True).reverse()
        s, d_, w_, rp = g.src, g.dst, g.weight, g.rowptr
    else:
        s, d_, w_ = (torch.from_numpy(a) for a in pad_edges(
            src, dst, w, n, ec=lay.get("ec"), seg_max=lay.get("seg_max")))
        rp = torch.from_numpy(build_rowptr(d_.numpy(), n))
    msgs = torch.from_numpy(x).index_select(0, s.long())
    return msgs, d_, w_, rp, src, dst, w, x, n


@pytest.mark.parametrize("share_edges", SHARE_SIZES)
@pytest.mark.parametrize("name", SHARE_CASES)
def test_weighted_shares_plain_matches_plain_and_f64(name, share_edges):
    """The weighted f32 sum by the kernel's schedule equals the plain
    version and the float64 oracle of Σ w·x[src]; empty rows are 0."""
    msgs, d_, w_, rp, src, dst, w, x, n = _edges(name)
    got = block_segment_sum_shares_plain(msgs, rp, "f32", weight=w_,
                                         share_edges=share_edges).numpy()
    assert got.shape == (n, x.shape[1])
    abssum = _oracle(src, dst, np.abs(w), np.abs(x), n)
    plain = block_segment_sum_plain(msgs, d_, rp, "f32", weight=w_).numpy()
    _assert_close_abssum(got, plain, abssum, SHARE_SUM_RTOL, F64_ATOL)
    _assert_close_abssum(got, _oracle(src, dst, w, x, n), abssum,
                         SHARE_SUM_RTOL, F64_ATOL)
    assert not got[(rp[1:] == rp[:-1]).numpy()].any()
    if name == "giant_row" and share_edges <= 32:
        sch = share_schedule(rp, msgs.shape[0], share_edges)
        assert int((sch.last_share - sch.first_share).max()) >= 50


@pytest.mark.parametrize("share_edges", [1, 7, SHARE_EDGES])
@pytest.mark.parametrize("mode", ["f32", "bf16", "hilo"])
@pytest.mark.parametrize("name", ["giant_row", "share_boundaries",
                                  "empty_on_boundaries", "single_row"])
def test_every_mode_by_shares_matches_plain(name, mode, share_edges):
    """Unweighted f32, bf16 and hilo over the messages ``w·x[src]`` (the
    probe's; the weight-0 padding adds nothing): the same terms by the
    schedule and by ``index_add_``; the bf16 and hilo terms are rounded
    (not f32's)."""
    msgs, d_, w_, rp, *_ = _edges(name)
    msgs = w_[:, None] * msgs
    got = block_segment_sum_shares_plain(msgs, rp, mode,
                                         share_edges=share_edges)
    want = block_segment_sum_plain(msgs, d_, rp, mode)
    abssum = block_segment_sum_plain(msgs.abs(), d_, rp).numpy()
    _assert_close_abssum(got.numpy(), want.numpy(), abssum, SHARE_SUM_RTOL,
                         F64_ATOL)
    if mode != "f32":
        assert (got - block_segment_sum_plain(msgs, d_, rp)).abs().max() > 0


@pytest.mark.parametrize("share_edges", [1, 7, SHARE_EDGES])
@pytest.mark.parametrize("name", ["interpret", "giant_row",
                                  "share_boundaries", "single_row"])
def test_shares_plain_with_row_pointer_not_at_zero(name, share_edges):
    """A clamped row pointer (``rowptr[0] != 0``, as the hub block alone
    and the chunked path pass it): edges outside ``[rowptr[0],
    rowptr[-1])`` belong to no row, in both plain versions."""
    msgs, d_, w_, rp, *_ = _edges(name)
    e = msgs.shape[0]
    lo, hi = e // 3 + 1, 2 * e // 3 + 5
    rp_mid = rp.clamp(lo, hi)
    assert int(rp_mid[0]) == lo
    got = block_segment_sum_shares_plain(msgs, rp_mid, "f32", weight=w_,
                                         share_edges=share_edges)
    oracle = np.zeros(got.shape)
    terms = (w_[:, None].double() * msgs.double()).numpy()
    np.add.at(oracle, d_[lo:hi].numpy(), terms[lo:hi])
    abssum = np.zeros(got.shape)
    np.add.at(abssum, d_[lo:hi].numpy(), np.abs(terms[lo:hi]))
    for have in (got, block_segment_sum_plain(msgs, d_, rp_mid, "f32",
                                              weight=w_)):
        _assert_close_abssum(have.numpy(), oracle, abssum, SHARE_SUM_RTOL,
                             F64_ATOL)
    assert not got[(rp_mid[1:] == rp_mid[:-1]).numpy()].any()


@pytest.mark.parametrize("mode", ["f32", "bf16", "hilo"])
@pytest.mark.parametrize("name", ["giant_row", "empty_on_boundaries"])
def test_shares_plain_accumulates_into_out(name, mode):
    """``out=``: every row gets out + Σ; empty rows keep out."""
    msgs, d_, w_, rp, *_ = _edges(name)
    weight = w_ if mode == "f32" else None
    if weight is None:
        msgs = w_[:, None] * msgs
    prev = torch.from_numpy(np.random.default_rng(5).normal(
        size=(rp.shape[0] - 1, msgs.shape[1])).astype(np.float32))
    out = prev.clone()
    got = block_segment_sum_shares_plain(msgs, rp, mode, out=out,
                                         weight=weight, share_edges=32)
    assert got is out
    want = block_segment_sum_plain(msgs, d_, rp, mode, out=prev.clone(),
                                   weight=weight)
    abssum = block_segment_sum_plain(msgs.abs(), d_, rp).numpy()
    _assert_close_abssum(got.numpy(), want.numpy(),
                         abssum + prev.abs().numpy(), SHARE_SUM_RTOL,
                         F64_ATOL)
    empty = (rp[1:] == rp[:-1]).numpy()
    assert empty.any() == (name == "empty_on_boundaries")
    np.testing.assert_array_equal(got.numpy()[empty], prev.numpy()[empty])


@pytest.mark.parametrize("name", ["interpret", "giant_row", "rev_rectangular"])
def test_weight_equals_premultiplied_messages(name):
    """The weighted f32 sum is the unweighted sum of ``weight·msgs``,
    bit for bit: one rounded product per term, the same order."""
    msgs, d_, w_, rp, *_ = _edges(name)
    pre = w_[:, None] * msgs
    assert torch.equal(block_segment_sum(msgs, d_, rp, "f32", weight=w_),
                       block_segment_sum(pre, d_, rp, "f32"))
    assert torch.equal(
        block_segment_sum_shares_plain(msgs, rp, "f32", weight=w_,
                                       share_edges=7),
        block_segment_sum_shares_plain(pre, rp, "f32", share_edges=7))


@pytest.mark.parametrize("mode", ["bf16", "hilo", "stream"])
def test_weight_outside_f32_raises(mode):
    msgs, d_, w_, rp, *_ = _edges("interpret")
    for fn in (lambda: block_segment_sum(msgs, d_, rp, mode, weight=w_),
               lambda: block_segment_sum_plain(msgs, d_, rp, mode,
                                               weight=w_)):
        with pytest.raises(ValueError, match="f32 mode only"):
            fn()
    if mode == "stream":
        with pytest.raises(ValueError, match="no share schedule"):
            block_segment_sum_shares_plain(msgs, rp, mode)


@pytest.mark.parametrize("name", ["giant_row", "share_boundaries",
                                  "single_row", "rev_rectangular"])
def test_xla_spmm_matches_jax_spmm_coo(name):
    """The ``xla`` SpMM (row gather, then D1 with the weight inside)
    against JAX's ``spmm_coo`` forward, its custom VJP's x-gradient, and
    ``_spmm_coo_chunked`` with chunk boundaries inside rows."""
    src, dst, w, x, n, n_src, _ = _share_case(name)
    rng = np.random.default_rng(9)
    cot = rng.normal(size=(n, x.shape[1])).astype(np.float32)
    gj = j_build_graph(src, dst, w, n, n_src, with_pallas=True,
                       with_ell=False)
    gt = build_graph(src, dst, w, n, n_src, device="cpu", with_pallas=True,
                     impl="xla")
    xt = torch.from_numpy(x).requires_grad_()
    out = spmm(gt, xt)
    (out * torch.from_numpy(cot)).sum().backward()
    want = np.asarray(j_spmm_mod.spmm_coo(gj.src, gj.dst, gj.weight,
                                          jnp.asarray(x), n))
    want_gx = np.asarray(jax.grad(lambda x_: jnp.sum(
        j_spmm_mod._spmm_core((False, False, False), gj, x_) * cot))(
            jnp.asarray(x)))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, rtol=1e-5,
                               atol=1e-5)
    chunk = 1001
    got_c = xla_spmm(gt.src, gt.dst, gt.weight, gt.rowptr,
                     torch.from_numpy(x), chunk=chunk).numpy()
    want_c = np.asarray(j_spmm_mod._spmm_coo_chunked(
        gj.src, gj.dst, gj.weight, jnp.asarray(x), n, True, chunk=chunk))
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [None, 1001])
def test_xla_spmm_has_no_separate_weight_product(monkeypatch, chunk):
    """The edge weight goes into D1's f32 pass: each chunk's messages
    reach ``block_segment_sum`` as the bare gathered rows ``x[src]``,
    with the chunk's weight slice beside them, and no in-place product
    runs on any tensor."""
    spmm_mod = importlib.import_module("recbole_gnn_tpu_torch.ops.spmm")
    src, dst, w, x, n, n_src, _ = _share_case("giant_row")
    g = build_graph(src, dst, w, n, n_src, device="cpu", with_pallas=True,
                    impl="xla")
    xt = torch.from_numpy(x)
    seen = []

    def recording(msgs, dst_, rowptr, mode, out=None, weight=None):
        seen.append((msgs.clone(), weight))
        return block_segment_sum(msgs, dst_, rowptr, mode, out=out,
                                 weight=weight)

    def no_mul_(*_):
        raise AssertionError("xla_spmm ran an in-place product")

    monkeypatch.setattr(spmm_mod, "block_segment_sum", recording)
    monkeypatch.setattr(torch.Tensor, "mul_", no_mul_)
    got = xla_spmm(g.src, g.dst, g.weight, g.rowptr, xt, chunk=chunk)
    monkeypatch.undo()
    e = g.src.shape[0]
    step = e if chunk is None else chunk
    assert len(seen) == -(-e // step)
    for i, (msgs, weight) in enumerate(seen):
        s = i * step
        assert torch.equal(msgs, xt[g.src[s:s + step].long()])
        assert torch.equal(weight, g.weight[s:s + step])
    want = block_segment_sum_plain(xt[g.src.long()], g.dst, g.rowptr, "f32",
                                   weight=g.weight)
    abssum = block_segment_sum_plain(xt[g.src.long()].abs(), g.dst, g.rowptr,
                                     "f32", weight=g.weight.abs()).numpy()
    _assert_close_abssum(got.numpy(), want.numpy(), abssum, SHARE_SUM_RTOL,
                         F64_ATOL)


def test_public_wrapper_has_no_share_size():
    """The share size is the module's constant: the public wrapper takes
    none (only the uncounted private call does)."""
    assert "share_edges" not in inspect.signature(block_segment_sum).parameters
    assert "share_edges" in inspect.signature(
        sum_mod._block_segment_sum_cuda).parameters


@pytest.mark.parametrize("e,d", [(1_703_936, 64), (2_007_040, 64), (5, 3)])
def test_weighted_work(e, d):
    """The weighted bound's bytes: the message stream, dst, weight and
    row pointer read once, the output written once."""
    n = 70_841
    msgs = torch.empty((e, d))
    rowptr = torch.empty(n + 1, dtype=torch.int64)
    n_bytes, flops = d1_probe.work(msgs, rowptr, weighted=True)
    assert n_bytes == e * d * 4 + 2 * e * 4 + (n + 1) * 8 + n * d * 4
    assert flops == 2 * e * d
    assert d1_probe.work(msgs, rowptr) == (n_bytes - e * 4, e * d)
