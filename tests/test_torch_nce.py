"""The all-node InfoNCE denominator (``ops/nce.py``) and ``info_nce``'s
use of it (``models/losses.py``).

On the CPU:

* ``info_nce`` on CPU tensors (the plain version: the logits by a
  matmul and ``torch.logsumexp``, or the checkpointed chunks above the
  threshold) against the JAX package's ``info_nce`` and a float64
  reference, loss and the three gradients, in both branches, with and
  without weights, for ``sum`` and ``mean``; ``nce_lse_plain``'s
  chunked branch against its unchunked one.
* The wrapper takes the plain version for CPU tensors, launches
  nothing, and ``info_nce`` counts ``nce_calls`` (every call) under the
  innermost open span, and no ``nce_kernel`` (the kernel's launches).
* The split plan covers every tile with non-empty splits, and a small
  n (NCL's centroids) still fills the SMs.
* The launch contract's checks raise on what the kernel does not take,
  and ``check_width`` (SGL's and NCL's check of ``embedding_size`` on a
  card) takes the widths the kernel holds and no other.

On the card (marked ``cuda``; skipped without one; run there with
``python -m pytest --noconftest -m cuda tests/test_torch_nce.py``:
this directory's ``conftest.py`` and the CPU tests import JAX, which
the machine with the card does not run), at SGL's two shapes, at an
NCL centroid shape, at ragged ones and at rows of 68 to 128 floats (the
kernels' D = 128 instance): the kernel pair against the
plain version in float64 (lse, dv1, dav2), reruns and a captured
graph's replays bit for bit, the launch counts, and the checks on CUDA
inputs.

The JAX package is imported inside the CPU tests only, and runs on its
CPU backend there.
"""

import os

import numpy as np
import pytest
import torch

from recbole_gnn_tpu_torch.models import losses
from recbole_gnn_tpu_torch.ops import nce
from recbole_gnn_tpu_torch.utils import trace

os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))

TAU = 0.2


def _inputs(b, n, d, seed=0):
    rng = np.random.default_rng(seed)
    v1, v2 = (rng.normal(size=(b, d)).astype(np.float32) for _ in range(2))
    av2 = rng.normal(size=(n, d)).astype(np.float32)
    w = np.ones(b, np.float32)
    w[-3:] = 0.0
    w[1] = 0.5
    return v1, v2, av2, w


def _f64_info_nce(v1, v2, av2, w, tau, reduction):
    """InfoNCE in float64 from its definition."""
    def n(x):
        return x / np.sqrt((x * x).sum(-1, keepdims=True) + 1e-12)
    z1, z2, za = (n(x.astype(np.float64)) for x in (v1, v2, av2))
    logits = z1 @ za.T / tau
    m = logits.max(-1)
    lse = m + np.log(np.exp(logits - m[:, None]).sum(-1))
    loss = lse - (z1 * z2).sum(-1) / tau
    ww = np.ones_like(loss) if w is None else w.astype(np.float64)
    if reduction == "sum":
        return float((loss * ww).sum())
    return float((loss * ww).sum() / max(ww.sum(), 1.0))


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_plain_version_matches_jax_and_float64(monkeypatch, chunked,
                                               weighted, reduction):
    jax = pytest.importorskip("jax", reason="the JAX package's reference "
                              "runs where JAX is installed")
    import jax.numpy as jnp

    from recbole_gnn_tpu.models import losses as j_losses
    b, n, d = 9, 2300, 8
    v1, v2, av2, w = _inputs(b, n, d, seed=3)
    w = w if weighted else None
    if chunked:   # 3 chunks of 1,024 rows (the minimum chunk), the last short
        monkeypatch.setattr(j_losses, "_NCE_CHUNK_ENTRIES", 1)
        monkeypatch.setattr(losses, "_NCE_CHUNK_ENTRIES", 1)
    calls = []
    real = nce.chunked_lse
    monkeypatch.setattr(nce, "chunked_lse",
                        lambda *a: calls.append(1) or real(*a))
    tt = [torch.from_numpy(a).requires_grad_() for a in (v1, v2, av2)]
    got = losses.info_nce(*tt[:2], TAU, all_view2=tt[2],
                          weight=None if w is None else torch.from_numpy(w),
                          reduction=reduction)
    got.backward()
    assert bool(calls) == chunked
    # JAX on its CPU backend, in full f32, where a card would give it
    # reduced-precision matmuls
    with jax.default_device(jax.devices("cpu")[0]):
        want, grads = jax.value_and_grad(
            lambda a, b_, c: j_losses.info_nce(
                a, b_, TAU, weight=None if w is None else jnp.asarray(w),
                all_view2=c, reduction=reduction),
            argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (v1, v2, av2)))
    # f32 against f32 (JAX) and against float64: sums of 2,300 terms
    # rounded in f32, about 1e-7 of the loss
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(got.detach()),
                               _f64_info_nce(v1, v2, av2, w, TAU, reduction),
                               rtol=1e-5, atol=1e-6)
    for a, g in zip(tt, grads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("n", [1024, 2300, 3072])
def test_chunked_plain_version_equals_unchunked(n):
    # L2-normalised rows, as info_nce passes them
    v1, av2 = (losses._l2n(torch.from_numpy(x))
               for x in _inputs(6, n, 8, seed=n)[::2])
    outs = []
    for entries in (nce.CHUNK_ENTRIES, 1):
        a, b = (x.clone().requires_grad_() for x in (v1, av2))
        lse = nce.nce_lse_plain(a, b, TAU, chunk_entries=entries)
        g = torch.autograd.grad(lse.sum(), (a, b))
        outs.append((lse.detach(), *g))
    # the same terms summed in another grouping: f32 rounding only
    for x, y in zip(*outs):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_count_under_the_span(
        monkeypatch):
    v1, v2, av2, w = (torch.from_numpy(x) for x in _inputs(5, 40, 8))
    before = (nce.nce_lse.launches, nce.nce_lse_grad.launches)
    store = trace.SpanStore()
    monkeypatch.setattr(trace, "count", store.count)
    with store.span("fit"), store.span("step"):
        a = losses.info_nce(v1, v2, TAU, weight=w, all_view2=av2)
        b = losses.info_nce(v1, v2, TAU)        # in-batch negatives
    losses.info_nce(v1, v2, TAU, all_view2=av2)  # outside every span
    snap = store.snapshot()["unprofiled"]
    assert snap["fit/step"]["counters"] == {"nce_calls": 2}
    assert snap[""]["counters"] == {"nce_calls": 1}
    assert not snap["fit"]["counters"]
    assert (nce.nce_lse.launches, nce.nce_lse_grad.launches) == before
    z1, za = losses._l2n(v1), losses._l2n(av2)
    torch.testing.assert_close(nce.nce_lse(z1, za, TAU),
                               torch.logsumexp(z1 @ za.T / TAU, -1))
    assert torch.isfinite(a) and torch.isfinite(b)


@pytest.mark.parametrize("b,n", [(2048, 29859), (2048, 40982), (2048, 1000),
                                 (2048, 70841), (300, 257), (5, 3)])
def test_plan_covers_every_tile_with_non_empty_splits(b, n):
    for stationary, streamed in ((nce._tiles(b), nce._tiles(n)),
                                 (nce._tiles(n), nce._tiles(b))):
        splits, per = nce._plan(stationary, streamed, 132)
        assert splits * per >= streamed > (splits - 1) * per


def test_plan_fills_the_card_at_sgl_and_ncl_shapes():
    # (splits, tiles a split) on 132 SMs.  SGL (B 2,048 = 16 tiles;
    # 29,859 and 40,982 rows = 234 and 321 tiles): the forward one wave
    # of 128 blocks, the backward's 321 tiles of k over 2 row splits
    assert nce._plan(16, 234, 132) == (8, 30)
    assert nce._plan(16, 321, 132) == (8, 41)
    assert nce._plan(321, 16, 132) == (2, 8)
    # NCL's centroids (1,000 rows = 8 tiles): 128 blocks each way, not 8
    assert nce._plan(16, 8, 132) == (8, 1)
    assert nce._plan(8, 16, 132) == (16, 1)


@pytest.mark.parametrize("bad,error", [
    ("bf16", TypeError), ("f64", TypeError), ("width6", ValueError),
    ("width132", ValueError), ("strided", ValueError), ("widths", ValueError),
    ("empty", ValueError), ("tau", ValueError), ("1d", ValueError)])
def test_launch_contract_checks_raise(bad, error):
    v1, av2 = torch.randn(8, 64), torch.randn(30, 64)
    tau = TAU
    if bad == "bf16":
        v1 = v1.bfloat16()
    elif bad == "f64":
        av2 = av2.double()
    elif bad == "width6":
        v1, av2 = v1[:, :6].contiguous(), av2[:, :6].contiguous()
    elif bad == "width132":
        v1, av2 = torch.randn(8, 132), torch.randn(30, 132)
    elif bad == "strided":
        av2 = torch.randn(64, 30).T
    elif bad == "widths":
        av2 = av2[:, :32].contiguous()
    elif bad == "empty":
        av2 = av2[:0]
    elif bad == "tau":
        tau = 0.0
    elif bad == "1d":
        v1 = v1[0]
    with pytest.raises(error):
        nce._check(v1, av2, tau)


@pytest.mark.parametrize("d,ok", [(4, True), (64, True), (96, True),
                                  (100, True), (128, True), (0, False),
                                  (50, False), (130, False), (132, False),
                                  (256, False)])
def test_check_width_takes_the_widths_the_kernel_holds(d, ok):
    if ok:
        nce.check_width(d, "SGL embedding_size")
    else:
        with pytest.raises(ValueError, match="SGL embedding_size"):
            nce.check_width(d, "SGL embedding_size")


# -- the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_inputs(b, n, d, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k = (torch.randn(r, d, generator=g, device=device) for r in (b, n))
    q, k = (losses._l2n(x).contiguous() for x in (q, k))
    return q, k, torch.rand(b, generator=g, device=device)


def _run(fn, q, k, g, tau=TAU):
    q, k = (x.detach().requires_grad_(True) for x in (q, k))
    lse = fn(q, k, tau)
    return (lse.detach(), *torch.autograd.grad(lse, (q, k), g))


def _rel(a, b):
    return float((a.double() - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(2048, 29859, 64), (2048, 40982, 64),
                                   (2048, 1000, 64), (300, 257, 64),
                                   (130, 129, 32), (5, 3, 4),
                                   (2048, 29859, 128), (2048, 1000, 100),
                                   (300, 257, 96), (5, 3, 68)])
def test_kernel_matches_the_float64_plain_version(card, b, n, d):
    q, k, g = _card_inputs(b, n, d, card, seed=b + n)
    lse, dq, dk = _run(nce.nce_lse, q, k, g)
    ref = _run(nce.nce_lse_plain, q.double(), k.double(), g.double())
    f32 = _run(nce.nce_lse_plain, q, k, g)
    # lse: the f32 plain version reads up to ~1.0e-6 here (its logits'
    # sum of up to 4e4 terms and max + log, at |lse| ~ 12, where one
    # f32 ulp is 9.5e-7); the kernel sums in another order and in log2
    # units, ~1.1e-6 (H100): 4e-6 leaves room and is far below a lost
    # term (exp(-2 / 0.2) / 4e4 ~ 1e-9 per term, but any wrong tile is
    # ~1e-2)
    assert float((lse.double() - ref[0]).abs().max()) < 4e-6
    assert float((f32[0].double() - ref[0]).abs().max()) < 4e-6
    # dv1, dav2, relative to their largest entry: the f32 plain version
    # reads up to ~1.2e-6, the kernel ~1.7e-6 (H100)
    for got, want in ((dq, ref[1]), (dk, ref[2])):
        assert _rel(got, want) < 5e-6
    # reruns repeat bit for bit: no atomics, sums in a fixed order
    for x, y in zip((lse, dq, dk), _run(nce.nce_lse, q, k, g)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_captured_graph_replays_bit_for_bit_and_counts_launches(card):
    q, k, g = _card_inputs(2048, 40982, 64, card, seed=5)
    qa, ka = q.clone().requires_grad_(True), k.clone().requires_grad_(True)

    def step():
        lse = nce.nce_lse(qa, ka, TAU)
        return (lse, *torch.autograd.grad(lse, (qa, ka), g))

    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    before = (nce.nce_lse.launches, nce.nce_lse_grad.launches)
    with torch.cuda.stream(side):
        eager = [t.clone() for t in step()]
    torch.cuda.current_stream(card).wait_stream(side)
    assert (nce.nce_lse.launches - before[0],
            nce.nce_lse_grad.launches - before[1]) == (1, 1)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    captured = (nce.nce_lse.launches, nce.nce_lse_grad.launches)
    assert (captured[0] - before[0], captured[1] - before[1]) == (2, 2)
    replays = []
    for _ in range(2):
        graph.replay()
        replays.append([t.clone() for t in out])
    torch.cuda.synchronize(card)
    # replays run no Python: the counts stay
    assert (nce.nce_lse.launches, nce.nce_lse_grad.launches) == captured
    for a, b_, c in zip(eager, *replays):
        assert torch.equal(a, b_) and torch.equal(b_, c)


@pytest.mark.cuda
def test_info_nce_on_the_card_counts_the_kernel(card, monkeypatch):
    v1, v2, av2, w = (torch.from_numpy(x).to(card)
                      for x in _inputs(64, 3000, 64, seed=9))
    store = trace.SpanStore()
    monkeypatch.setattr(trace, "count", store.count)
    with store.span("step"):
        got = losses.info_nce(v1, v2, TAU, weight=w, all_view2=av2)
    assert store.snapshot()["unprofiled"]["step"]["counters"] == \
        {"nce_calls": 1, "nce_kernel": 1}
    want = _f64_info_nce(*(x.cpu().numpy() for x in (v1, v2, av2, w)), TAU,
                         "sum")
    assert abs(float(got) - want) < 1e-5 * abs(want)


@pytest.mark.cuda
@pytest.mark.parametrize("bad,error", [("bf16", TypeError),
                                       ("width6", ValueError),
                                       ("width132", ValueError),
                                       ("strided", ValueError)])
def test_cuda_inputs_the_kernel_does_not_take_raise(card, bad, error):
    v1, av2 = torch.randn(8, 64, device=card), torch.randn(30, 64, device=card)
    if bad == "bf16":
        v1, av2 = v1.bfloat16(), av2.bfloat16()
    elif bad == "width6":
        v1, av2 = v1[:, :6].contiguous(), av2[:, :6].contiguous()
    elif bad == "width132":
        v1 = torch.randn(8, 132, device=card)
        av2 = torch.randn(30, 132, device=card)
    elif bad == "strided":
        av2 = torch.randn(64, 30, device=card).T
    before = nce.nce_lse.launches
    with pytest.raises(error):
        nce.nce_lse(v1, av2, TAU)
    assert nce.nce_lse.launches == before
