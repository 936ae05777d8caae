"""Port parity: K2's rows as the sums of their real slots
(``sparse_spmm_impl: ell``).

Each virtual row of the ELL layout holds ``vlen`` real slots and then
pad slots (weight 0 on row 0), which the JAX einsum multiplies like any
other.  Here, on the CPU and at small sizes: ``vlen`` against the JAX
package's layout (its rows' real slots, and the pad slots past them);
the pad-free plain version (``ell_spmm_pad_free_plain``: real slots
only, ``0 · x[0]`` once per padded row; ``chip_smoke.py`` holds the
kernel against it on the card) against JAX ``ell_spmm``, with finite
inputs and with a non-finite ``x[0]`` or a zero-weight real edge whose
source row is not finite; ``vlen`` through ``with_ws``,
``ell_reweight`` and ``Graph.reverse()``.

Tolerances: the two sum the same f32 terms, possibly in another order,
so |port − JAX| ≤ 1e-6 · Σ|terms| elementwise (a 256-term row in
another order stays well inside); NaN positions are compared exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.ops import ell_spmm as j_ell
from recbole_gnn_tpu_torch.ops import ell_spmm as t_ell
from recbole_gnn_tpu_torch.ops.spmm import build_graph

RTOL_ABSSUM = 1e-6


def _case(name):
    """(src, dst, w, n_dst, n_src, build_ell kwargs), dst-sorted: a Zipf
    hub graph with edges from row 0, the same with k_cap 8 (most nodes
    split), a rectangular graph with isolated rows, a 3-bucket grid, and
    degrees on the bucket widths and K_CAP with a tenth isolated."""
    rng = np.random.default_rng({"zipf": 21, "split": 22, "rect": 23,
                                 "few_buckets": 24, "boundaries": 25}[name])
    if name == "rect":
        n_dst, n_src, e = 120, 300, 2500
        dst = rng.integers(1, n_dst - 10, e)
        src = rng.integers(0, n_src, e)
    elif name == "boundaries":
        n_dst = n_src = 600
        deg = rng.choice([0, 1, 2, 4, 7, 8, 9, 64, 255, 256, 257, 513],
                         n_dst, p=[0.1, 0.15, 0.15, 0.1, 0.05, 0.1, 0.05,
                                   0.1, 0.06, 0.06, 0.04, 0.04])
        dst = np.repeat(np.arange(n_dst), deg)
        src = rng.integers(0, n_src, len(dst))
    else:
        n_dst = n_src = 400
        e = 4000
        dst = (rng.zipf(1.3, e) - 1) % n_dst
        src = rng.integers(0, n_src, e)
        src[::97] = 0                       # real edges from row 0
    kw = {"split": {"k_cap": 8}, "few_buckets": {"max_buckets": 3}}.get(
        name, {})
    w = rng.normal(size=len(dst)).astype(np.float32)
    o = np.argsort(dst, kind="stable")
    return src[o], dst[o], w[o], n_dst, n_src, kw


NAMES = ["zipf", "split", "rect", "few_buckets", "boundaries"]


def _layouts(name):
    s, d, w, n_dst, n_src, kw = _case(name)
    jm = j_ell.build_ell(s, d, w, n_dst, with_epos=True, **kw)
    tm = t_ell.build_ell(s, d, w, n_dst, with_epos=True, **kw)
    return (s, d, w, n_dst, n_src), jm, tm


def _jax(jm, x):
    return np.asarray(j_ell.ell_spmm(jm, jnp.asarray(x)))


def _abssum(s, d, w, n_dst, x):
    out = np.zeros((n_dst, x.shape[1]), np.float64)
    np.add.at(out, d, np.abs(w).astype(np.float64)[:, None]
              * np.abs(x[s]).astype(np.float64))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_vlen_counts_the_jax_rows_real_slots(name):
    (s, _, _, _, _), jm, tm = _layouts(name)
    n_edges = len(s)
    assert tm.vlen.dtype == torch.int32
    assert tm.vlen.shape == (tm.n_vrows,) and int(tm.vlen.sum()) == n_edges
    for k, vl, idx, w, ep in zip(tm.ks, tm.vlens, jm.idxs, jm.ws, jm.eposs):
        idx, w, ep = np.asarray(idx), np.asarray(w), np.asarray(ep)
        vl = vl.numpy()
        np.testing.assert_array_equal(vl, (ep != n_edges).sum(1))
        assert (vl >= 1).all() and (vl <= k).all()
        pad = np.arange(k)[None, :] >= vl[:, None]
        assert (idx[pad] == 0).all() and (w[pad] == 0).all()
        assert (ep[pad] == n_edges).all() and (ep[~pad] < n_edges).all()


@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("name", NAMES)
def test_pad_free_plain_matches_jax(name, d):
    (s, dd, w, n_dst, n_src), jm, tm = _layouts(name)
    x = np.random.default_rng(31).normal(size=(n_src, d)).astype(np.float32)
    got = t_ell.ell_spmm_pad_free_plain(tm, torch.from_numpy(x)).numpy()
    want = _jax(jm, x)
    bound = RTOL_ABSSUM * _abssum(s, dd, w, n_dst, x)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= bound).all()
    empty = np.bincount(dd, minlength=n_dst) == 0
    assert not got[empty].any()


@pytest.mark.parametrize("value", [np.inf, -np.inf, np.nan])
@pytest.mark.parametrize("name", NAMES)
def test_non_finite_x0_spreads_as_in_jax(name, value):
    """A pad slot multiplies x[0] by 0 in the JAX einsum: every padded
    row turns NaN in the columns where x[0] is not finite.  The pad-free
    version adds 0 · x[0] once per padded row and gets the same NaNs."""
    (s, dd, w, n_dst, n_src), jm, tm = _layouts(name)
    x = np.random.default_rng(32).normal(size=(n_src, 8)).astype(np.float32)
    x[0, [1, 5]] = value
    got = t_ell.ell_spmm_pad_free_plain(tm, torch.from_numpy(x)).numpy()
    want = _jax(jm, x)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    bound = RTOL_ABSSUM * _abssum(s, dd, w, n_dst, np.where(
        np.isfinite(x), x, 0))
    assert (np.abs(got[fin] - want[fin]) <= bound[fin]).all()


@pytest.mark.parametrize("name", NAMES)
def test_zero_weight_real_edge_is_still_gathered(name):
    """Pads are told by position, never by weight: a real edge of weight
    0 whose source row holds inf gives NaN (0 · inf) in its row, in the
    pad-free version as in the JAX einsum."""
    s, dd, w, n_dst, n_src, kw = _case(name)
    w = w.copy()
    e = int(np.flatnonzero(s != 0)[len(s) // 3])
    w[e] = 0.0
    jm = j_ell.build_ell(s, dd, w, n_dst, **kw)
    tm = t_ell.build_ell(s, dd, w, n_dst, **kw)
    x = np.random.default_rng(33).normal(size=(n_src, 8)).astype(np.float32)
    x[s[e], 2] = np.inf
    got = t_ell.ell_spmm_pad_free_plain(tm, torch.from_numpy(x)).numpy()
    want = _jax(jm, x)
    assert np.isnan(want[dd[e], 2])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))


def test_vlen_survives_reweight_and_reverse():
    s, d, w, n_dst, n_src, _ = _case("zipf")
    g = build_graph(s, d, w, n_dst, n_src, device="cpu", impl="ell")
    m = g.ell
    m2 = t_ell.with_ws(m, t_ell.reweight_ws(m, g.weight * 3))
    m3 = t_ell.ell_reweight(m, g.weight * 0.5)
    for other in (m2, m3):
        assert other.vlen is m.vlen and other.launch is None
    g2 = g.with_weight(g.weight * 2, rebuild_ell=True)
    assert torch.equal(g2.ell.vlen, g.ell.vlen)
    assert torch.equal(g2.rev_ell.vlen, g.rev_ell.vlen)
    gr = g.reverse()
    assert gr.ell.vlen is g.rev_ell.vlen and gr.rev_ell.vlen is g.ell.vlen
    # the transpose layout's vlen counts the reverse rows' real slots
    assert int(g.rev_ell.vlen.sum()) == g.nnz


def test_pad_free_plain_on_graph_layouts_matches_plain():
    """Forward and transpose layouts of one graph: the pad-free version
    equals the plain ``ell_spmm`` (the JAX composition in torch) within
    the same bound."""
    s, d, w, n_dst, n_src, _ = _case("boundaries")
    g = build_graph(s, d, w, n_dst, n_src, device="cpu", impl="ell")
    rng = np.random.default_rng(34)
    for meta, n_in in ((g.ell, n_src), (g.rev_ell, n_dst)):
        x = torch.from_numpy(rng.normal(size=(n_in, 16)).astype(np.float32))
        got = t_ell.ell_spmm_pad_free_plain(meta, x)
        want = t_ell.ell_spmm_plain(meta, x)
        absm = dataclasses.replace(meta, w=meta.w.abs())
        bound = RTOL_ABSSUM * t_ell.ell_spmm_plain(absm, x.abs())
        assert ((got - want).abs() <= bound).all()


def test_empty_layout_pad_free():
    m = t_ell.build_ell(np.zeros(0, int), np.zeros(0, int), np.zeros(0), 5)
    assert m.vlen.shape == (0,)
    out = t_ell.ell_spmm_pad_free_plain(m, torch.ones(3, 4))
    assert out.shape == (5, 4) and not out.any()
