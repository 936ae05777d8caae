"""Port parity: K1's per-call packed table and D1's share schedule on
bf16 messages, the arithmetic of the two kernels' designs as the CPU
reaches it through their plain forms.

* ``pack_table`` (the plain form of K1's pack pass: x̃ = hi + lo per
  element, once per call) against the JAX package's ``_hi_lo_bits``
  pack ``xh + xl``, and the terms formed from it (``packed_terms``)
  against the JAX composition's per-edge terms (``_pallas_spmm_jit``:
  ``m32 = (xh + xl)·w`` split again by ``_hi_lo_bits``) and against the
  split of x per gathered element that the kernel ran before: bit for
  bit, on seeded inputs with zeros, ±large values and subnormals, for an
  f32 and a bf16 x (a bf16 x is read as it is, so a -0 there gives a
  zero term of the other sign than the split's +0, which no f32 sum
  from +0 can show; the values are equal).  XLA on the CPU flushes subnormal results of its
  arithmetic to zero, where the port (torch on the CPU, and the CUDA
  kernel, built without ``-ftz``) keeps them: every entry is held bit
  for bit against numpy's IEEE float32 arithmetic, and against JAX
  where neither the entry nor the x element it comes from is subnormal
  (there JAX's value is a zero).
* ``segment_spmm_plain(..., "packed")`` on those inputs stays within
  ``1e-6·Σ|w·x|`` of the Pallas kernel in interpret mode.
* ``block_segment_sum_shares_plain`` on bf16 messages with the edge
  weight, at share sizes 1 and 128, from a row pointer that does or does
  not start at 0, into a new output or ``out=``: its terms equal the JAX
  composition's (``x[src] * w.astype(bf16)``) bit for bit, and its sums
  lie within one bf16 unit (2⁻⁷·|value|) + 1e-4·Σ|term| of JAX's terms
  summed exactly and rounded once, and of ``block_segment_sum_plain``.
  (JAX's own ``segment_sum`` adds bf16 messages in bf16, drifting from
  the exact sum as a row's terms pile up; ``test_torch_bf16_ops.py``
  bounds that drift.)
* ``share_sum_plain``, the share schedule both share passes follow:
  bit for bit its definition (each row's partial in each share summed
  in edge order, a split row's partials added in share order), at share
  sizes 1, 3 and 128, with a row spanning thousands of shares.
* the pack pass's workspace shape, and the build log reader that
  ``chip_smoke.py`` prints each kernel's registers and spills with.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.ops.pallas_spmm import _hi_lo_bits as j_hi_lo_bits
from recbole_gnn_tpu.ops.pallas_spmm import build_pallas_meta, pallas_spmm
from recbole_gnn_tpu_torch.ops import cuda_build
from recbole_gnn_tpu_torch.ops.segment_spmm import (_hi_lo_bits,
                                                    build_rowptr, pack_table,
                                                    pack_workspace_shape,
                                                    packed_terms, pad_edges,
                                                    segment_spmm_plain,
                                                    share_sum_plain)
from recbole_gnn_tpu_torch.ops.segment_sum import (
    SHARE_EDGES as D1_SHARE_EDGES, _terms, block_segment_sum_plain,
    block_segment_sum_shares_plain)

BF16 = torch.bfloat16
TINY = np.float32(2.0 ** -126)   # the smallest normal float32


def _special_x(n: int, d: int, seed: int, big: float = 3.0e38
               ) -> np.ndarray:
    """(n, d) f32: normal draws, with zeros of both signs, ±large values
    (up to ``big``), subnormals and values whose lo plane rounds up in
    each row's first columns."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    special = np.array([0.0, -0.0, big, -big, 1.0e30, -1.0e30,
                        1e-40, -3e-39, 1.0 + 2.0 ** -8 + 2.0 ** -9,
                        -(1.0 + 2.0 ** -7 + 2.0 ** -8 + 2.0 ** -20)],
                       np.float32)
    x[:, :len(special)] = special[(np.arange(n)[:, None]
                                   + np.arange(len(special))) % len(special)]
    return x


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _subnormal(a: np.ndarray) -> np.ndarray:
    return (np.abs(a) < TINY) & (a != 0)


def _same(got: np.ndarray, want: np.ndarray, zero_sign: bool = True):
    """Bit for bit; without ``zero_sign``, a zero of either sign for a
    zero (the values equal, the bits of every other entry equal)."""
    if zero_sign:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_array_equal(got, want)
        nz = want != 0
        np.testing.assert_array_equal(_bits(got)[nz], _bits(want)[nz])


def _hold_against_jax(got: np.ndarray, ieee: np.ndarray, jax_val,
                      x_in: np.ndarray, zero_sign: bool = True):
    """``got`` equals numpy's IEEE value everywhere, and JAX's where
    neither that value nor the x element it comes from (``x_in``) is
    subnormal (there JAX flushed to a zero): bit for bit, or
    :func:`_same` without ``zero_sign``."""
    j = np.asarray(jax_val, np.float32)
    _same(got, ieee, zero_sign)
    sub = _subnormal(ieee) | _subnormal(x_in)
    assert 0 < (~sub).sum()
    _same(got[~sub], j[~sub], zero_sign)
    assert (j[sub] == 0).all()


def _np_hi_lo(x: np.ndarray):
    """hi = x truncated to its top 16 bits, lo = bf16(x − hi), in numpy's
    IEEE float32 arithmetic (subnormals kept)."""
    hi = (x.view(np.int32) & np.int32(-65536)).view(np.float32)
    lo = torch.from_numpy(x - hi).to(BF16).float().numpy()
    return hi, lo


def test_pack_table_equals_jax_hi_lo_pack():
    x = _special_x(64, 24, 1)
    jh, jl = j_hi_lo_bits(jnp.asarray(x))
    hi, lo = _np_hi_lo(x)
    got = pack_table(torch.from_numpy(x)).numpy()
    _hold_against_jax(got, hi + lo,
                      jh.astype(jnp.float32) + jl.astype(jnp.float32), x)
    # exact: hi + lo has at most 16 significant bits
    np.testing.assert_array_equal(got.astype(np.float64),
                                  hi.astype(np.float64) + lo)
    xb = torch.from_numpy(x).to(BF16)
    assert pack_table(xb) is xb                     # read as it is


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_terms_equal_jax_and_the_per_edge_split(dtype):
    rng = np.random.default_rng(2)
    n, e, d = 40, 600, 24
    x = _special_x(n, d, 3)
    if dtype == "bf16":
        x = torch.from_numpy(x).to(BF16).float().numpy()
    src = rng.integers(0, n, e)
    w = rng.uniform(-1.0, 1.0, e).astype(np.float32)
    w[:5] = [0.0, -0.0, 1.0, -1.0, 2.0 ** -20]
    xt = torch.from_numpy(x) if dtype == "f32" else \
        torch.from_numpy(x).to(BF16)
    mh, ml = packed_terms(pack_table(xt), torch.from_numpy(src),
                          torch.from_numpy(w))
    # JAX's composition: x in f32, split, m32 = (xh + xl)·w, split again
    jh, jl = j_hi_lo_bits(jnp.asarray(x))
    m32 = (jh.astype(jnp.float32) + jl.astype(jnp.float32))[src] \
        * jnp.asarray(w)[:, None]
    jmh, jml = j_hi_lo_bits(m32)
    # the same in IEEE float32, and the split per gathered element that
    # the kernel ran before the pack (x[src] split on every edge)
    # (a bf16 x is read as it is: a -0 stays -0 where the split gives +0,
    # so a term may be a zero of the other sign; an f32 sum starts at +0
    # and never turns -0, so no row's sum can tell)
    exact = dtype == "f32"
    hi, lo = _np_hi_lo(x[src])
    m = (hi + lo) * w[:, None]
    nh, nl = _np_hi_lo(m)
    _hold_against_jax(mh.numpy(), nh, jmh.astype(jnp.float32), x[src], exact)
    _hold_against_jax(ml.numpy(), nl, jml.astype(jnp.float32), x[src], exact)
    oh, ol = _hi_lo_bits(torch.from_numpy(x).index_select(
        0, torch.from_numpy(src)))
    old = (oh + ol) * torch.from_numpy(w)[:, None]
    for got, want in zip((mh, ml), _hi_lo_bits(old)):
        _same(got.numpy(), want.numpy(), exact)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_spmm_on_special_values_matches_pallas_interpret(dtype):
    rng = np.random.default_rng(4)
    n, e, d = 64, 1500, 64
    # ±3e36: a row's f32 sums of ~25 such terms stay finite
    x = _special_x(n, d, 5, big=3.0e36)
    dst, src = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.uniform(-1.0, 1.0, e).astype(np.float32)
    s, d_, w_ = pad_edges(src, dst, w, n)
    meta = build_pallas_meta(d_, n)
    xj = jnp.asarray(x) if dtype == "f32" else \
        jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(pallas_spmm(jnp.asarray(s), jnp.asarray(d_),
                                  jnp.asarray(w_), xj, meta,
                                  precision="packed", interpret=True))[:n]
    xt = torch.from_numpy(x) if dtype == "f32" else \
        torch.from_numpy(x).to(BF16)
    t = torch.from_numpy
    got = segment_spmm_plain(t(s), t(d_), t(w_), xt, n, "packed").numpy()
    xf = xt.float().numpy().astype(np.float64)
    abssum = np.zeros((n, d))
    np.add.at(abssum, d_, np.abs(w_.astype(np.float64))[:, None]
              * np.abs(xf[s]))
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 1e-6 * abssum + 1e-30).all()


def _bf16_case(seed: int = 6):
    """A dst-sorted graph with empty rows and a hub row, its bf16
    messages ``x[src]``, the f32 weight and the CSR row pointer."""
    rng = np.random.default_rng(seed)
    n, e, d = 120, 2400, 16
    dst = np.sort(np.concatenate([rng.integers(0, n // 2, e - 400) * 2,
                                  np.full(400, 7)]))
    src = rng.integers(0, n, e)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=e).astype(np.float32)
    rp = build_rowptr(dst, n)
    return x, src, dst, w, rp


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("share_edges", [1, D1_SHARE_EDGES])
def test_d1_bf16_share_schedule_matches_jax_terms(share_edges, offset,
                                                  accumulate):
    x, src, dst, w, rp = _bf16_case()
    e = len(src)
    if offset:                            # rowptr[0] != 0: a middle cut
        rp = np.clip(rp, e // 3 + 1, 2 * e // 3)
    msgs = torch.from_numpy(x).to(BF16)[torch.from_numpy(src)]
    wt, rpt = torch.from_numpy(w), torch.from_numpy(rp)
    # JAX's terms: x[src] * w.astype(bf16), a bf16 product
    jterms = np.asarray((jnp.asarray(x).astype(jnp.bfloat16)[src]
                         * jnp.asarray(w).astype(jnp.bfloat16)[:, None])
                        .astype(jnp.float32))
    np.testing.assert_array_equal(_bits(_terms(msgs, "f32", wt).numpy()),
                                  _bits(jterms))
    n, d = len(rp) - 1, x.shape[1]
    lo, hi = rp[0], rp[-1]
    exact, abssum = np.zeros((n, d)), np.zeros((n, d))
    np.add.at(exact, dst[lo:hi], jterms[lo:hi].astype(np.float64))
    np.add.at(abssum, dst[lo:hi], np.abs(jterms[lo:hi]).astype(np.float64))
    prev = torch.from_numpy(np.random.default_rng(7).normal(
        size=(n, d)).astype(np.float32)).to(BF16)
    if accumulate:
        exact = exact + prev.float().numpy()
        abssum = abssum + np.abs(prev.float().numpy())
    want = torch.from_numpy(exact.astype(np.float32)).to(BF16).float().numpy()
    got = block_segment_sum_shares_plain(
        msgs, rpt, "f32", out=prev.clone() if accumulate else None,
        weight=wt, share_edges=share_edges)
    plain = block_segment_sum_plain(
        msgs, torch.from_numpy(dst.astype(np.int32)), rpt, "f32",
        out=prev.clone() if accumulate else None, weight=wt)
    assert got.dtype == plain.dtype == BF16
    g = got.float().numpy()
    for ref in (want, plain.float().numpy()):
        assert (np.abs(g - ref) <= 2.0 ** -7 * np.abs(ref)
                + 1e-4 * abssum).all()
    empty = rp[1:] == rp[:-1]
    if accumulate:       # rows without edges keep out's values
        np.testing.assert_array_equal(g[empty], prev.float().numpy()[empty])
    else:
        assert (g[empty] == 0).all()


@pytest.mark.parametrize("share_edges", [1, 3, 128])
def test_share_sum_plain_is_its_schedule_bit_for_bit(share_edges):
    rng = np.random.default_rng(11)
    n, e, d = 40, 6000, 5
    dst = np.sort(np.where(rng.random(e) < 0.6, 7,       # a hub row
                           rng.integers(0, n, e)))
    rp = build_rowptr(dst, n)
    rp = np.clip(rp, 5, e)                   # rowptr[0] != 0
    m = (rng.normal(size=(e, d))
         * 10.0 ** rng.integers(-4, 5, (e, 1))).astype(np.float32)
    got = share_sum_plain(torch.from_numpy(m), torch.from_numpy(rp),
                          share_edges).numpy()
    want = np.zeros((n, d), np.float32)
    for r in range(n):
        a, b = rp[r], rp[r + 1]
        if b <= a:
            continue
        edges = np.arange(a, b)
        parts = [np.add.accumulate(m[edges[edges // share_edges == s]])[-1]
                 for s in range(a // share_edges,
                                (b - 1) // share_edges + 1)]
        want[r] = np.add.accumulate(np.stack(parts))[-1]
    assert (rp[8] - rp[7]) // share_edges > 1000 or share_edges == 128
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_pack_workspace_shape():
    x = torch.zeros(7, 48)
    assert pack_workspace_shape(x, "packed") == (7, 48)
    assert pack_workspace_shape(x, "bf16") is None
    assert pack_workspace_shape(x, "f32x2") is None
    assert pack_workspace_shape(x.to(BF16), "packed") is None


def test_ptxas_usage_reads_each_entry_function():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    16 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
"""
    got = cuda_build.ptxas_usage(log)
    assert [(g["registers"], g["stack_bytes"], g["spill_stores"],
             g["spill_loads"]) for g in got] == [(64, 16, 16, 24),
                                                 (40, 0, 0, 0)]
    assert [g["function"] for g in got] == ["_Z3fooPf", "_Z3barv"]
