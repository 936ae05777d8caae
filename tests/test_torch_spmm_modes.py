"""Port parity: K1's ``packed`` and ``bf16`` precisions
(``pallas_spmm_precision``).

The port's plain versions (``segment_spmm_plain``, what
``segment_spmm`` runs for CPU tensors in those modes) against the JAX
package's Pallas kernel in interpret mode, as ``tests/test_ops.py``
runs it, on the same padded edge lists.  Both form each term the same
way (bf16: the f32 product rounded to bf16; packed: x split into
truncated hi and rounded lo bf16 planes, the per-edge product split
again, the planes summed apart) and differ only in the order of their
f32 sums, so they agree to ``|Δ| ≤ 1e-6·Σ|w·x|`` elementwise.  The
CUDA kernel's modes run only on the card; ``chip_smoke.py`` holds them
against the same plain versions.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.ops.pallas_spmm import _hi_lo_bits as j_hi_lo_bits
from recbole_gnn_tpu.ops.pallas_spmm import build_pallas_meta, pallas_spmm
from recbole_gnn_tpu_torch.ops import segment_spmm as seg_mod
from recbole_gnn_tpu_torch.ops.segment_spmm import (PRECISIONS, _hi_lo_bits,
                                                    build_rowptr, pad_edges,
                                                    segment_spmm,
                                                    segment_spmm_plain,
                                                    segment_spmm_transpose)
from recbole_gnn_tpu_torch.ops.spmm import build_graph, spmm

TOL_REL_ABSSUM = 1e-6


def _case(name):
    """(src, dst, w, x, n, layout kwargs): test_ops.py's multi-segment
    Zipf case, its default-layout case, and D = 48 (a packed width that
    the JAX package pads to 64)."""
    rng = np.random.default_rng({"multisegment": 21, "interpret": 11,
                                 "d48": 41}[name])
    if name == "multisegment":
        n, e, d, lay = 100, 1000, 64, {"ec": 64, "seg_max": 256, "bm": 32}
        dst = (rng.zipf(1.3, size=e) % n).astype(np.int64)
    else:
        n, e, d, lay = 300, 5000, 48 if name == "d48" else 64, {}
        dst = rng.integers(0, n, e)
    src = rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return src, dst, w, x, n, lay


@pytest.mark.parametrize("precision", ["bf16", "packed"])
@pytest.mark.parametrize("name", ["multisegment", "interpret", "d48"])
def test_plain_mode_matches_pallas_interpret(name, precision):
    src, dst, w, x, n, lay = _case(name)
    ec, seg_max = lay.get("ec"), lay.get("seg_max")
    s, d_, w_ = pad_edges(src, dst, w, n, ec=ec, seg_max=seg_max)
    meta = build_pallas_meta(d_, n, bm=lay.get("bm"), ec=ec, seg_max=seg_max)
    want = np.asarray(pallas_spmm(jnp.asarray(s), jnp.asarray(d_),
                                  jnp.asarray(w_), jnp.asarray(x), meta,
                                  precision=precision, interpret=True))[:n]
    t = lambda a: torch.from_numpy(a)
    before = seg_mod.segment_spmm.launches
    got = segment_spmm(t(s), t(d_), t(w_), t(build_rowptr(d_, n)), t(x),
                       precision).numpy()
    assert seg_mod.segment_spmm.launches == before   # CPU: no launch
    np.testing.assert_array_equal(
        got, segment_spmm_plain(t(s), t(d_), t(w_), t(x), n,
                                precision).numpy())
    abssum = np.zeros((n, x.shape[1]))
    np.add.at(abssum, d_, np.abs(w_.astype(np.float64))[:, None]
              * np.abs(x[s]))
    assert (np.abs(got - want) <= TOL_REL_ABSSUM * abssum).all()
    # the mode really rounds: bf16 is far from the f32 sum, packed close
    exact = segment_spmm(t(s), t(d_), t(w_), t(build_rowptr(d_, n)),
                         t(x)).numpy()
    gap = np.abs(got - exact).max()
    assert (gap > 1e-2) if precision == "bf16" else (0 < gap < 1e-3)


def test_hi_lo_bits_equals_jax():
    x = np.random.default_rng(3).normal(size=(64, 33)).astype(np.float32)
    x[0, :4] = [0.0, -0.0, 1e-30, -3.4e38]
    hi, lo = _hi_lo_bits(torch.from_numpy(x))
    jh, jl = j_hi_lo_bits(jnp.asarray(x))
    np.testing.assert_array_equal(hi.numpy(),
                                  np.asarray(jh.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.numpy(),
                                  np.asarray(jl.astype(jnp.float32)))


def test_transpose_passes_the_precision(monkeypatch):
    seen = []
    monkeypatch.setattr(seg_mod, "segment_spmm_plain",
                        lambda *a: seen.append(a[-1]) or a[3][:a[4]])
    src, dst = torch.tensor([0, 1], dtype=torch.int32), torch.tensor(
        [0, 1], dtype=torch.int32)
    segment_spmm_transpose(src, dst, torch.ones(2),
                           torch.tensor([0, 1, 2]), torch.ones(2, 4),
                           "packed")
    assert seen == ["packed"]


@pytest.mark.parametrize("precision", ["bf16", "packed"])
def test_graph_runs_precision_on_the_card_only(precision):
    """A pallas graph in bf16/packed runs f32 on a CPU tensor (the JAX
    package runs its Pallas kernel, and so its precision, only on the
    TPU); the autograd function hands the graph's precision to the
    kernel for a CUDA tensor, forward and transpose."""
    src, dst, w, x, n, _ = _case("interpret")
    g = build_graph(src, dst, w, n, device="cpu", with_pallas=True,
                    impl="pallas", precision=precision)
    got = spmm(g, torch.from_numpy(x)).numpy()
    oracle = np.zeros((n, x.shape[1]))
    np.add.at(oracle, dst, w.astype(np.float64)[:, None] * x[src])
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    fn = inspect.getsource(seg_mod.SegmentSpmmFunction.forward)
    assert 'graph.precision if x.device.type == "cuda"' in fn
    assert "ctx.precision" in inspect.getsource(
        seg_mod.SegmentSpmmFunction.backward)


def test_unknown_precision_raises():
    assert PRECISIONS == ("f32x2", "bf16", "packed")
    with pytest.raises(ValueError, match="precision"):
        segment_spmm_plain(torch.zeros(1, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32), torch.ones(1),
                           torch.ones(1, 4), 1, "fp8")
