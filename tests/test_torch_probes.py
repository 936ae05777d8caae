"""Port parity: D1 (block segment sum) and D2 (row gather) against the
TPU probe kernels they replace, run in Pallas interpret mode from the
unmodified scripts, plus the port's probe entry points on the CPU.

The probe scripts run their full-size probe when imported, so the
kernels (and the probe's own ``pallas_call`` set-up) are taken out of
their source with ``ast`` and run at a small size: D1 at E = 3 × 2048
edges over 150 nodes, D = 64 padded to the TPU's 128 lanes; D2 at 1,024
rows of a 300 × 128 table with C = 256 rows per program.

Tolerances: ``stream`` exact; ``bf16`` and ``hilo`` within
1e-6 · Σ|m| per element (the same bf16-rounded terms summed in f32 in
another order); ``f32`` within 1e-5 · Σ|m| of a float64 oracle; D2 bit
for bit.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from recbole_gnn_tpu_torch.diag import pallas_floor as d1_probe
from recbole_gnn_tpu_torch.diag import row_gather as d2_probe
from recbole_gnn_tpu_torch.ops.gather import row_gather, row_gather_plain
from recbole_gnn_tpu_torch.ops.segment_spmm import build_rowptr
from recbole_gnn_tpu_torch.ops.segment_sum import (block_segment_sum,
                                                   block_segment_sum_plain)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIAG = os.path.join(ROOT, "scripts", "diag")
N_PASS = {"stream": 0, "bf16": 1, "hilo": 2}


def _parse(name):
    with open(os.path.join(DIAG, name)) as f:
        return ast.parse(f.read())


def _def(tree, name):
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _interpret(stmts):
    """The statements, with ``interpret=True`` added to every
    ``pl.pallas_call``, compiled as one module."""
    mod = ast.Module(body=stmts, type_ignores=[])
    for node in ast.walk(mod):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "pallas_call"):
            node.keywords.append(ast.keyword(arg="interpret",
                                             value=ast.Constant(True)))
    return compile(ast.fix_missing_locations(mod), "<probe>", "exec")


def _d1_probe(n_pass, msgs, dst, block_ptr, n, d):
    """scripts/diag/pallas_floor.py: ``BM, EC``, ``make_kernel`` and
    ``run``'s set-up up to its jitted pallas_call, run on these
    inputs."""
    tree = _parse("pallas_floor.py")
    consts = next(s for s in tree.body if isinstance(s, ast.Assign)
                  and isinstance(s.targets[0], ast.Tuple)
                  and [t.id for t in s.targets[0].elts] == ["BM", "EC"])
    run = _def(tree, "run")
    setup = run.body[:next(i for i, s in enumerate(run.body)
                           if isinstance(s, ast.Assign)
                           and isinstance(s.targets[0], ast.Name)
                           and s.targets[0].id == "f") + 1]
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu, "np": np,
          "msgs": jnp.asarray(msgs), "d_": jnp.asarray(dst), "N": n, "D": d,
          "n_pass": n_pass}
    exec(_interpret([consts, _def(tree, "make_kernel")] + setup), ns)
    assert (ns["BM"], ns["EC"]) == (64, 2048)
    out = ns["f"](jnp.asarray(block_ptr), ns["d3"], ns["m2"])
    return np.asarray(out)[:n, :d]


@pytest.fixture(scope="module")
def d1_case():
    rng = np.random.default_rng(0)
    n, e, d = 150, 3 * 2048, 64
    # Zipf rows on the even nodes: a hub row spanning two chunks, and
    # every odd row empty
    dst = np.sort(2 * ((rng.zipf(1.5, e) - 1) % (n // 2))).astype(np.int32)
    msgs = rng.normal(size=(e, d)).astype(np.float32)
    rowptr = build_rowptr(dst, n)
    block_ptr = rowptr[np.minimum(np.arange(-(-n // 64) + 1) * 64, n)]
    assert (np.diff(rowptr) == 0).any() and np.diff(rowptr).max() > 2048
    t = torch.from_numpy
    port = (t(msgs), t(dst), t(rowptr))
    absum = block_segment_sum_plain(t(np.abs(msgs)), *port[1:]).numpy()
    return msgs, dst, block_ptr.astype(np.int32), n, d, port, absum


@pytest.mark.parametrize("mode", list(N_PASS))
def test_d1_matches_tpu_probe_interpret(d1_case, mode):
    msgs, dst, block_ptr, n, d, port, absum = d1_case
    want = _d1_probe(N_PASS[mode], msgs, dst, block_ptr, n, d)
    before = block_segment_sum.launches
    got = block_segment_sum(*port, mode).numpy()
    assert block_segment_sum.launches == before     # CPU: no kernel launch
    assert got.shape == want.shape == (n, d)
    if mode == "stream":
        np.testing.assert_array_equal(got, want)
        assert 0 < (got != 0).any(1).sum() < n      # placeholder rows only
    else:
        assert (np.abs(got - want) <= 1e-6 * absum).all()
        # and the modes are what they say: rounding moved the sum
        f32 = block_segment_sum(*port, "f32").numpy()
        assert np.abs(got - f32).max() > 0


def test_d1_f32_matches_f64_oracle(d1_case):
    msgs, dst, _, n, d, port, absum = d1_case
    oracle = np.zeros((n, d))
    np.add.at(oracle, dst, msgs.astype(np.float64))
    got = block_segment_sum(*port, "f32").numpy()
    assert (np.abs(got - oracle) <= 1e-5 * absum).all()
    empty = np.diff(port[2].numpy()) == 0
    assert not got[empty].any()


@pytest.mark.parametrize("mode", ["f32", "bf16", "hilo", "stream"])
def test_d1_accumulates_into_out(d1_case, mode):
    """A given out is added into in place, as the TPU kernel's prev_ref
    alias is (the sum rounds in another order: 1e-6 of the terms)."""
    *_, port, absum = d1_case
    prev = np.random.default_rng(1).normal(size=absum.shape).astype(
        np.float32)
    out = torch.from_numpy(prev.copy())
    got = block_segment_sum(*port, mode, out=out)
    assert got is out
    want = prev + block_segment_sum(*port, mode).numpy()
    assert (np.abs(got.numpy() - want) <= 1e-6 * (np.abs(prev) + absum)).all()


def test_d1_block_size_and_chunk_only_move_stream(d1_case):
    """bm and ec change only the stream mode's placeholder rows; the
    sums of the other modes do not depend on the blocking."""
    *_, port, _ = d1_case
    for mode in ("f32", "bf16", "hilo"):
        torch.testing.assert_close(block_segment_sum(*port, mode, bm=32),
                                   block_segment_sum(*port, mode),
                                   rtol=0, atol=0)
    a = block_segment_sum(*port, "stream", bm=32, ec=1024)
    b = block_segment_sum(*port, "stream")
    assert not torch.equal(a, b)


def test_d1_rejects_bad_modes_and_layouts(d1_case):
    *_, port, _ = d1_case
    with pytest.raises(ValueError, match="mode"):
        block_segment_sum(*port, "packed")
    with pytest.raises(ValueError, match="multiple of ec"):
        block_segment_sum(port[0][:-1], port[1][:-1],
                          torch.clamp(port[2], max=port[0].shape[0] - 1),
                          "stream")
    with pytest.raises(ValueError, match="bm"):
        block_segment_sum(*port, bm=0)


def _d2_probe(x, idx):
    """scripts/diag/r3_sparse_probe4.py case Q: its ``kernel`` and its
    grid spec and ``pallas_call``, with C = 256, PIPE = 8."""
    case_q = _def(_parse("r3_sparse_probe4.py"), "case_q")
    kernel = next(s for s in case_q.body if isinstance(s, ast.FunctionDef))
    spec = [s for s in case_q.body if isinstance(s, ast.Assign)
            and isinstance(s.targets[0], ast.Name)
            and s.targets[0].id in ("grid_spec", "gather")]
    assert [s.targets[0].id for s in spec] == ["grid_spec", "gather"]
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu, "C": 256,
          "PIPE": 8, "E": idx.shape[0], "D": x.shape[1]}
    exec(_interpret([kernel] + spec), ns)
    return np.asarray(ns["gather"](jnp.asarray(idx), jnp.asarray(x)))


def test_d2_matches_tpu_probe_interpret():
    rng = np.random.default_rng(2)
    n, e, d = 300, 1024, 128
    idx = rng.integers(0, n, e).astype(np.int32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    want = _d2_probe(x, idx)
    before = row_gather.launches
    got = row_gather(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    assert row_gather.launches == before
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [1, 33, 48, 64, 130])
def test_d2_plain_any_width(d):
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(40, d)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, 97).astype(np.int32))
    assert torch.equal(row_gather_plain(x, idx), x[idx.long()])


def test_probe_entry_points_on_cpu(capsys):
    """Both probes run on the CPU at a small size (plain versions) and
    print a line per mode and their results as JSON."""
    r1 = d1_probe.main(["--device", "cpu", "--nodes", "150", "--edges",
                        "6000", "--reps", "1"])
    r2 = d2_probe.main(["--device", "cpu", "--nodes", "300", "--edges",
                        "1000", "--reps", "1"])
    out = capsys.readouterr().out
    assert set(r1["modes"]) == {"f32", "bf16", "hilo", "stream"}
    assert r1["e_pad"] == 8192 and r1["device"] == "cpu"
    assert all(m["max_abs_err"] == 0 for m in r1["modes"].values())
    assert r2["max_abs_err"] == 0 and r2["bytes"] > 1000 * 128 * 4
    for word in ("f32", "bf16", "hilo", "stream", "D2 row_gather"):
        assert word in out


def test_probe_inputs_follow_the_tpu_probes():
    """D1: default_rng(0), edges padded with pad_edges (2M → 2,007,040
    at the full shape); D2: default_rng(2), idx drawn before x."""
    msgs, dst, rowptr = d1_probe.make_inputs("cpu", n=50, e=300, d=8)
    rng = np.random.default_rng(0)
    src, dst0 = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    assert msgs.shape == (4096, 8) and int(rowptr[-1]) == 4096
    np.testing.assert_array_equal(dst.numpy()[:300], np.sort(dst0))
    x, idx = d2_probe.make_inputs("cpu", n=70, e=90, d=4)
    rng = np.random.default_rng(2)
    np.testing.assert_array_equal(idx.numpy(), rng.integers(0, 70, 90))
    np.testing.assert_array_equal(x.numpy(), rng.normal(size=(70, 4))
                                  .astype(np.float32))
    from recbole_gnn_tpu_torch.ops.segment_spmm import segment_layout
    assert np.prod(segment_layout(d1_probe.E)) == 2_007_040


def test_probes_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        return
    for probe in (d1_probe, d2_probe):
        with pytest.raises(RuntimeError, match="--device cpu"):
            probe.main(["--nodes", "10", "--edges", "10"])
