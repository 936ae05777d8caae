"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's three CUDA kernels from ``recbole_gnn_tpu_torch/csrc``
(one ``nvcc`` each, all at once) and drives the port's paths end to end
through the entry points a user calls, on a seeded synthetic dataset of
the LightGCN paper's Gowalla shape (29,858 users × 40,981 items,
1,027,370 interactions) with LightGCN at its published width
(embedding_size 64, 3 layers) on the sparse graph:

1. ``sparse_spmm_impl: pallas`` training: ``run_recbole_gnn_tpu`` for
   2 epochs — 415 steps of 2,048 pairs each, every step 3 forward SpMMs
   (K1, ``segment_spmm``) and, in the backward, 3 transpose SpMMs (K1ᵀ)
   — with full-sort validation after each epoch, a checkpoint at the
   best epoch and the test evaluation;
2. ``pallas`` serving: ``export_artifact`` from that checkpoint, then
   ``RecServer`` for batches of 1/8/64/1024 users and one HTTP request;
3. ``sparse_spmm_impl: xla`` training, the same run with every SpMM
   made of the row gather (D2, ``row_gather``) and the block segment
   sum (D1, ``block_segment_sum``), forward and backward;
4. ``xla`` serving: export from the xla checkpoint and ``RecServer``;
5. the probes: D1 and D2 at the shapes of the TPU probes they replace
   (``recbole_gnn_tpu_torch.diag.pallas_floor`` / ``.row_gather``).

Each path runs with every launch counter set to 0 just before it and
read just after, and the counts are checked exactly.  Then it holds one
training step of each impl on the kernels against the same step on the
plain versions, every kernel against its plain version at the slice
shape and at edge-case shapes (D1 in all four modes), and times them.

Prints the card's name and power limit, the build, check and timing
lines, then a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Exits non-zero without a result
when there is no CUDA device or any check fails.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings

import numpy as np
import torch

SEED = 2020
N_LAYERS = 3
EMBEDDING_SIZE = 64
EPOCHS = 2
# the LightGCN paper's Gowalla statistics (He et al., 2020, Table 1)
GOWALLA_SHAPE = {"n_users": 29858, "n_items": 40981, "n_inter": 1027370}
BATCHES = (1, 8, 64, 1024)
TOP_K = 10
TIMED_STEPS = 25           # the separately timed sample of training steps
SOURCES = ("segment_spmm", "row_gather", "segment_sum")
D1_MODES = ("f32", "bf16", "hilo", "stream")
CHUNK = 100_003            # the forced xla chunk: boundaries inside rows

# |kernel − plain| ≤ TOL_REL_ABSSUM · Σ_e |term_e| elementwise: both sum
# the same f32 terms in another order, so their difference is bounded by
# a multiple of the unit roundoff times the sum of absolute terms (empty
# rows must match exactly: both write 0).  D2 must match bit for bit.
TOL_REL_ABSSUM = 1e-4

# one training step, kernel against plain: the same f32 sums in another
# order through 3 layers forward and 3 back, plus the atomics of
# PyTorch's own gather backward (final[user]), whose bits change from
# run to run.  Gradients: |Δ| ≤ STEP_RTOL·|g| + STEP_ATOL_FRAC·max|g|
# (the atol covers entries that cancel toward 0); the loss: STEP_RTOL.
STEP_RTOL = 1e-4
STEP_ATOL_FRAC = 1e-5


def log(msg: str):
    print(msg, flush=True)


def counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from recbole_gnn_tpu_torch.ops.gather import row_gather
    from recbole_gnn_tpu_torch.ops.segment_spmm import (
        segment_spmm, segment_spmm_transpose)
    from recbole_gnn_tpu_torch.ops.segment_sum import block_segment_sum
    return {"segment_spmm": segment_spmm,
            "segment_spmm_transpose": segment_spmm_transpose,
            "row_gather": row_gather, "block_segment_sum": block_segment_sum}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    """Launches by kernel; K1 forward = segment_spmm's count less the
    transpose's (segment_spmm_transpose launches through it)."""
    c = {k: fn.launches for k, fn in counters().items()}
    c["segment_spmm"] -= c["segment_spmm_transpose"]
    return c


# -- data ---------------------------------------------------------------

def write_gowalla_shape(root: str, name: str, seed: int, n_users: int,
                        n_items: int, n_inter: int, min_per_user: int = 10,
                        zipf_a: float = 0.8) -> str:
    """Write ``root/name/name.inter``: ``n_inter`` unique (user, item)
    pairs, every user with ≥ ``min_per_user`` and every item with ≥ 1
    interaction, user activity lognormal and item popularity Zipf-like
    (weight ∝ 1/rank^zipf_a)."""
    rng = np.random.default_rng(seed)
    act = rng.lognormal(0.0, 1.0, n_users)
    deg = min_per_user + rng.multinomial(
        n_inter - min_per_user * n_users, act / act.sum())
    assert deg.max() < n_items and deg.sum() == n_inter
    pop = 1.0 / np.arange(1, n_items + 1) ** zipf_a
    pop = (pop / pop.sum())[rng.permutation(n_items)]

    # every item once, each into a distinct user slot
    slots = rng.permutation(np.repeat(np.arange(n_users), deg))[:n_items]
    have = np.sort(slots.astype(np.int64) * n_items + np.arange(n_items))
    need = deg - np.bincount(slots, minlength=n_users)
    while need.sum() > 0:
        users = np.repeat(np.arange(n_users, dtype=np.int64), 2 * need + 2)
        key = users * n_items + rng.choice(n_items, len(users), p=pop)
        key = key[~np.isin(key, have)]
        key, first = np.unique(key, return_index=True)
        key = key[np.argsort(first)]          # draw order, not item order
        u = key // n_items
        order = np.argsort(u, kind="stable")
        u, key = u[order], key[order]
        rank = np.arange(len(u)) - np.searchsorted(u, u)
        take = rank < need[u]
        have = np.sort(np.concatenate([have, key[take]]))
        need -= np.bincount(u[take], minlength=n_users)
    have = have[rng.permutation(len(have))]
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{name}.inter")
    with open(path, "w", encoding="utf-8") as f:
        f.write("user_id:token\titem_id:token\n")
        f.write("\n".join(f"{u}\t{i}" for u, i in
                          zip((have // n_items).tolist(),
                              (have % n_items).tolist())))
        f.write("\n")
    return path


# -- timing and bounds ------------------------------------------------------

def time_cuda_ms(fn) -> float:
    from recbole_gnn_tpu_torch.diag.timing import time_ms
    return time_ms(fn, torch.device("cuda"))


def spmm_bytes(n_out: int, n_in: int, e: int, n_ptr: int,
               d: int) -> tuple[int, int]:
    """(bytes, flops) of one SpMM: x read once, out written once, the
    int32 gather index, the f32 weight and the int64 row pointer read
    once; 2·E·d flops."""
    return (n_in * d * 4 + n_out * d * 4 + e * 4 + e * 4 + n_ptr * 8,
            2 * e * d)


def sorted_csr(rows: torch.Tensor, cols: torch.Tensor, w: torch.Tensor,
               n_rows: int, n_cols: int) -> torch.Tensor:
    """CSR of real edges with the columns sorted in each row
    (cuSPARSE's invariants) — the ``torch.sparse.mm`` yardstick, which
    the port never calls."""
    key = rows.long() * n_cols + cols.long()
    order = torch.argsort(key)
    counts = torch.bincount(rows.long(), minlength=n_rows)
    rowptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=rows.device)
    rowptr[1:] = torch.cumsum(counts, 0)
    warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
    warnings.filterwarnings("ignore", message="Sparse invariant checks")
    return torch.sparse_csr_tensor(rowptr, cols.long()[order], w[order],
                                   size=(n_rows, n_cols),
                                   check_invariants=True)


# -- kernel vs plain ------------------------------------------------------

def hold(kind: str, name: str, got: torch.Tensor, want: torch.Tensor,
         abssum: torch.Tensor | None) -> float:
    """``got`` against ``want``: bit for bit without ``abssum``, else
    |err| ≤ TOL_REL_ABSSUM · abssum elementwise.  Returns max |err|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{kind} on {name}: shape {tuple(got.shape)} "
                             f"vs {tuple(want.shape)} or not finite")
    err = (got - want).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if abssum is None:
        if not torch.equal(got, want):
            raise AssertionError(f"{kind} differs from its plain version on "
                                 f"{name} (max_abs_err {max_err:.3e})")
    elif not bool((err <= TOL_REL_ABSSUM * abssum).all()):
        raise AssertionError(
            f"{kind} disagrees with its plain version on {name}: "
            f"max_abs_err {max_err:.3e} exceeds {TOL_REL_ABSSUM} x sum|term|")
    return max_err


def check_kernels(name: str, graph, x: torch.Tensor, g: torch.Tensor
                  ) -> tuple[float, float]:
    """K1 (forward, on x) and K1ᵀ (transpose, on the cotangent g) against
    their plain versions on the same inputs.  K1ᵀ is held against the
    plain version over the reverse arrays and, to check those arrays
    too, over the forward arrays with src and dst swapped.  Returns
    (max |err| forward, max |err| transpose)."""
    from recbole_gnn_tpu_torch.ops.segment_spmm import (
        segment_spmm, segment_spmm_transpose, spmm_coo)
    errs = []
    fwd = (graph.src, graph.dst, graph.weight)
    rev = (graph.rev_src, graph.rev_dst, graph.rev_weight)
    swapped = (graph.dst, graph.src, graph.weight)
    for kind, got, plains, inp, n_out in (
            ("K1", segment_spmm(graph.src, graph.dst, graph.weight,
                                graph.rowptr, x), (fwd,), x, graph.n_nodes),
            ("K1T", segment_spmm_transpose(graph.rev_src, graph.rev_dst,
                                           graph.rev_weight,
                                           graph.rev_rowptr, g),
             (rev, swapped), g, graph.n_src_nodes)):
        s, d, w = plains[0]
        abssum = spmm_coo(s, d, w.abs(), inp.abs(), n_out)
        max_err = max(hold(kind, name, got, spmm_coo(s, d, w, inp, n_out),
                           abssum) for s, d, w in plains)
        rp = graph.rowptr if kind == "K1" else graph.rev_rowptr
        log(f"kernel check {kind} {name}: rows={n_out} "
            f"e_pad={graph.src.numel()} d={inp.shape[1]} "
            f"max_abs_err={max_err:.3e} "
            f"empty_rows={int((rp[1:] == rp[:-1]).sum())}")
        errs.append(max_err)
    return errs[0], errs[1]


def check_xla_kernels(name: str, graph, x: torch.Tensor, g: torch.Tensor,
                      chunk: int | None = None) -> dict:
    """D2 and D1 against their plain versions on one graph: D2 gathers
    the forward messages (bit for bit); D1 sums them in every mode,
    into a new output and into a given one; then the whole ``xla``
    SpMM, forward over the graph and transpose over its reverse CSR
    (with ``chunk``, over forced edge chunks), against ``spmm_coo``.
    Returns the largest |err| per kernel."""
    from recbole_gnn_tpu_torch.ops.gather import row_gather, row_gather_plain
    from recbole_gnn_tpu_torch.ops.segment_spmm import spmm_coo
    from recbole_gnn_tpu_torch.ops.segment_sum import (
        block_segment_sum, block_segment_sum_plain)
    from recbole_gnn_tpu_torch.ops.spmm import xla_spmm
    d2 = hold("D2", name, row_gather(x, graph.src),
              row_gather_plain(x, graph.src), None)
    msgs = row_gather_plain(x, graph.src) * graph.weight[:, None]
    args = (msgs, graph.dst, graph.rowptr)
    prev = torch.randn(graph.n_nodes, x.shape[1], device=x.device)
    d1 = 0.0
    for mode in D1_MODES:
        # Σ|m| of what the mode adds (bf16 rounding moves |m| by < 0.4 %;
        # stream adds only the placeholder rows' own messages)
        abssum = block_segment_sum_plain(
            msgs.abs(), graph.dst, graph.rowptr,
            "stream" if mode == "stream" else "f32")
        d1 = max(d1, hold(f"D1 {mode}", name, block_segment_sum(*args, mode),
                          block_segment_sum_plain(*args, mode), abssum))
        d1 = max(d1, hold(f"D1 {mode} out=", name,
                          block_segment_sum(*args, mode, out=prev.clone()),
                          block_segment_sum_plain(*args, mode,
                                                  out=prev.clone()),
                          abssum + prev.abs()))
    spmm_err = 0.0
    for kind, arrays, inp, n_out in (
            ("xla", (graph.src, graph.dst, graph.weight, graph.rowptr), x,
             graph.n_nodes),
            ("xla T", (graph.rev_src, graph.rev_dst, graph.rev_weight,
                       graph.rev_rowptr), g, graph.n_src_nodes)):
        s, d, w, rp = arrays
        abssum = spmm_coo(s, d, w.abs(), inp.abs(), n_out)
        spmm_err = max(spmm_err, hold(
            kind, name, xla_spmm(s, d, w, rp, inp, chunk=chunk),
            spmm_coo(s, d, w, inp, n_out), abssum))
    log(f"kernel check D2/D1 {name}: rows={graph.n_nodes} "
        f"e_pad={graph.src.numel()} d={x.shape[1]} chunk={chunk} "
        f"D2 max_abs_err={d2:.3e} D1 (4 modes, new and out=) "
        f"max_abs_err={d1:.3e} xla SpMM fwd+T max_abs_err={spmm_err:.3e}")
    return {"row_gather": d2, "block_segment_sum": d1, "xla_spmm": spmm_err}


def edge_case_graphs(rng: np.random.Generator):
    """(name, src, dst, w, n_dst, n_src, d) of the CPU tests' edge cases
    and one rectangular bipartite graph (the transpose swaps the row
    counts)."""
    cases = []
    n, e = 200_000, 3_000_000                       # several 2^20 segments
    cases.append(("multi_segment", rng.integers(0, n, e),
                  rng.integers(0, n, e), n, n, 64))
    n, e = 5000, 20000                              # empty rows incl. PAD 0
    cases.append(("empty_rows", rng.integers(0, n, e),
                  2 * rng.integers(1, n // 4, e), n, n, 64))
    n, e = 1000, 5000                               # block-overrun shape
    cases.append(("overrun", rng.integers(0, n, e), rng.integers(0, n, e),
                  n, n, 64))
    n, e = 3000, 30000
    cases.append(("d48", rng.integers(0, n, e), rng.integers(0, n, e), n, n,
                  48))
    cases.append(("d33_scalar", rng.integers(0, n, e),
                  rng.integers(0, n, e), n, n, 33))
    cases.append(("d128", rng.integers(0, n, e), rng.integers(0, n, e), n, n,
                  128))
    cases.append(("d130_vec2_two_passes", rng.integers(0, n, e),
                  rng.integers(0, n, e), n, n, 130))
    cases.append(("d256_vec4_two_passes", rng.integers(0, n, e),
                  rng.integers(0, n, e), n, n, 256))
    n, e = 20000, 400_000                           # Zipf hub rows
    cases.append(("hub_rows", rng.integers(0, n, e),
                  (rng.zipf(1.3, e) - 1) % n, n, n, 64))
    n_dst, n_src, e = 30_000, 70_000, 1_500_000     # rectangular, Zipf src
    cases.append(("rectangular", (rng.zipf(1.3, e) - 1) % n_src,
                  rng.integers(1, n_dst, e), n_dst, n_src, 64))
    return [(nm, s, d_, rng.normal(size=len(s)).astype(np.float32), nd, ns,
             dim) for nm, s, d_, nd, ns, dim in cases]


# -- serving checks --------------------------------------------------------

def check_recommendations(srv, uids: np.ndarray, idx: np.ndarray,
                          vals: np.ndarray, ref_tables=None):
    """No PAD, no history item; with ``ref_tables`` also the top-k
    values against a float64 host computation."""
    if (idx == 0).any():
        raise AssertionError("PAD item recommended")
    for b, u in enumerate(uids):
        s, e = srv._hist_indptr[u], srv._hist_indptr[u + 1]
        if np.isin(idx[b], srv._hist_items[s:e]).any():
            raise AssertionError(f"history item recommended to user {u}")
    if not np.isfinite(vals).all():
        raise AssertionError("non-finite recommendation score")
    if ref_tables is not None:
        ut, it = ref_tables
        for b, u in enumerate(uids):
            scores = it.astype(np.float64) @ ut[u].astype(np.float64)
            s, e = srv._hist_indptr[u], srv._hist_indptr[u + 1]
            scores[srv._hist_items[s:e]] = -np.inf
            scores[0] = -np.inf
            want = np.sort(scores)[::-1][:len(vals[b])]
            np.testing.assert_allclose(vals[b], want, rtol=1e-4, atol=1e-7)
            np.testing.assert_allclose(scores[idx[b]], vals[b],
                                       rtol=1e-4, atol=1e-7)


def http_roundtrip(srv, users: list[str], k: int) -> dict:
    from recbole_gnn_tpu_torch.serve import make_http_server
    httpd = make_http_server(srv, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        body = json.dumps({"users": users, "k": k}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/recommend",
            data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)


# -- training ---------------------------------------------------------------

def train_config(tmp: str, impl: str) -> dict:
    """LightGCN at its published width on the sparse graph, 2 epochs of
    the default 2,048-pair batches, validation after each epoch; each
    impl checkpoints into its own directory."""
    ck = os.path.join(tmp, impl)
    return {"data_path": tmp, "checkpoint_dir": ck,
            "embedding_size": EMBEDDING_SIZE, "n_layers": N_LAYERS,
            "enable_sparse": True, "sparse_spmm_impl": impl,
            "epochs": EPOCHS, "eval_step": 1, "seed": SEED,
            "state": "ERROR", "save_dataset": True,
            "metrics_log_path": os.path.join(ck, "train.jsonl")}


def expected_train_counts(impl: str, steps: int, n_evals: int) -> dict:
    """pallas: K1 per layer per step and per evaluation, K1ᵀ per layer
    per step; xla: D2 and D1 once per layer in each forward (steps and
    evaluations) and once per layer in each backward."""
    fwd = N_LAYERS * (EPOCHS * steps + n_evals)
    bwd = N_LAYERS * EPOCHS * steps
    if impl == "pallas":
        return {"segment_spmm": fwd, "segment_spmm_transpose": bwd,
                "row_gather": 0, "block_segment_sum": 0}
    return {"segment_spmm": 0, "segment_spmm_transpose": 0,
            "row_gather": fwd + bwd, "block_segment_sum": fwd + bwd}


def check_metrics(name: str, result: dict):
    if not result or not all(math.isfinite(v) for v in result.values()):
        raise AssertionError(f"{name} metrics missing or not finite: {result}")


def time_train_steps(trainer, model, state: dict, host_batches: list,
                     dev) -> tuple[list[float], dict]:
    """Host-clock times (ms) of the training steps on ``host_batches``
    after 5 warm-up steps, each synchronised, from the trained
    checkpoint ``state``; a step is what ``fit`` does per batch: the
    batch to the device, loss, backward, Adam update.  Then 10 more
    steps under ``torch.profiler``: device time by kernel and the
    device's busy share of their wall time (empty where the profiler
    records no device activity)."""
    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    from recbole_gnn_tpu_torch.train.checkpoint import params_from_numpy
    params = params_from_numpy(state["params"], dev)
    for p in params.values():
        p.requires_grad_(True)
    opt_state = params_from_numpy(state["opt_state"], dev)
    rng = torch.Generator().manual_seed(SEED)

    def step(b):
        trainer.train_step(params, opt_state, model.consts, {},
                           to_device(b, dev), rng)

    times = []
    for b in host_batches[:5 + TIMED_STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    window = host_batches[5 + TIMED_STEPS:]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in window:
            step(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_us = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device_us[evt.key] = evt.self_device_time_total
    profile = {}
    if device_us:
        busy = sum(device_us.values())
        top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
        profile = {"steps": len(window),
                   "wall_ms_per_step": wall_us / len(window) / 1e3,
                   "device_ms_per_step": busy / len(window) / 1e3,
                   "device_busy_share": busy / wall_us,
                   "top_ms_per_step": {k[:60]: v / len(window) / 1e3
                                       for k, v in top}}
    return times[5:], profile


def step_vs_plain(model, params: dict, batch: dict, impl: str) -> dict:
    """One training step's loss and embedding gradients on the kernels
    against the same step with every SpMM replaced by the plain version,
    differentiated by autograd; same params, same batch.  The kernel
    step must launch its impl's kernels once per layer forward and once
    back, the plain step none.  Returns the errors; raises past the
    STEP_* tolerances."""
    import recbole_gnn_tpu_torch.models.layers as layers_mod
    from recbole_gnn_tpu_torch.ops.segment_spmm import spmm_coo

    def loss_and_grads():
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        loss, _ = model.calculate_loss(p, model.consts, {}, batch, None)
        grads = torch.autograd.grad(loss, [p["user_emb"], p["item_emb"]])
        torch.cuda.synchronize()
        return loss.detach(), grads

    want = ({"segment_spmm": N_LAYERS, "segment_spmm_transpose": N_LAYERS}
            if impl == "pallas" else
            {"row_gather": 2 * N_LAYERS, "block_segment_sum": 2 * N_LAYERS})
    reset_counts()
    k_loss, k_grads = loss_and_grads()
    got = {k: v for k, v in read_counts().items() if v}
    if got != want:
        raise AssertionError(f"the {impl} kernel step launched {got}, "
                             f"expected {want}")
    kernel_spmm = layers_mod.spmm_any
    layers_mod.spmm_any = lambda g, x: spmm_coo(g.src, g.dst, g.weight, x,
                                                g.n_nodes)
    try:
        reset_counts()
        p_loss, p_grads = loss_and_grads()
        if any(read_counts().values()):
            raise AssertionError("the plain step launched a kernel")
    finally:
        layers_mod.spmm_any = kernel_spmm
    out = {"loss_kernel": float(k_loss), "loss_plain": float(p_loss),
           "loss_abs_err": float((k_loss - p_loss).abs())}
    if not out["loss_abs_err"] <= STEP_RTOL * abs(out["loss_plain"]):
        raise AssertionError(f"kernel step loss differs from plain: {out}")
    for name, kg, pg in zip(("user_emb", "item_emb"), k_grads, p_grads):
        err = (kg - pg).abs()
        lim = STEP_RTOL * pg.abs() + STEP_ATOL_FRAC * pg.abs().max()
        out[f"grad_{name}_max_abs_err"] = float(err.max())
        out[f"grad_{name}_max_abs"] = float(pg.abs().max())
        if not (bool((err <= lim).all()) and bool(torch.isfinite(kg).all())):
            raise AssertionError(
                f"kernel step {name} gradient differs from plain: "
                f"max |err| {float(err.max()):.3e}, worst excess "
                f"{float((err - lim).max()):.3e}")
    return out


def train_path(tmp: str, impl: str, dev) -> dict:
    """Train through ``run_recbole_gnn_tpu`` with every counter set to 0
    just before and read just after; check the run; time its steps, an
    evaluation, and one step against the plain version."""
    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    from recbole_gnn_tpu_torch.models import get_model
    from recbole_gnn_tpu_torch.quick_start import (create_dataset,
                                                   data_preparation,
                                                   run_recbole_gnn_tpu)
    from recbole_gnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                       params_from_numpy)
    from recbole_gnn_tpu_torch.train.trainer import Trainer
    cd = train_config(tmp, impl)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = run_recbole_gnn_tpu(model="LightGCN", dataset="gowalla_shape",
                              config_dict=cd, saved=True, verbose=False)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    with open(cd["metrics_log_path"]) as f:
        events = [json.loads(line) for line in f]

    config = Config(model="LightGCN", dataset="gowalla_shape",
                    config_dict=cd)
    (train_loader, train_ds), (valid_loader, _), _ = data_preparation(
        config, create_dataset(config))
    model = get_model("LightGCN")(config, train_ds, dev)
    graph = model.consts["graph"]
    steps = len(train_loader)
    epochs = [e for e in events if e["event"] == "train_epoch"]
    valids = [e for e in events if e["event"] == "valid"]
    losses = [e["loss"] for e in epochs]
    log(f"[{impl}] train: {graph.n_nodes} nodes, {graph.nnz} edges (e_pad "
        f"{graph.n_edges_padded}); {steps} steps per epoch of "
        f"{train_loader.batch_size} pairs; {len(epochs)} epochs in "
        f"{wall:.1f} s end to end")
    for e in epochs:
        log(f"[{impl}] train epoch {e['epoch']}: loss {e['loss']:.6f}, "
            f"{e['seconds']:.3f} s, {e['examples_per_s']:.0f} examples/s")
    for e in valids:
        log(f"[{impl}] valid epoch {e['epoch']}: {e['seconds']:.3f} s, "
            f"recall@10 {e['recall@10']:.5f}, ndcg@10 {e['ndcg@10']:.5f}")
    log(f"[{impl}] test: {res['test_result']}")
    if len(losses) != EPOCHS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[{impl}] training losses: {losses}")
    if not losses[1] < losses[0]:
        raise AssertionError(f"[{impl}] loss did not fall: {losses}")
    for e in valids:
        check_metrics(f"[{impl}] valid epoch {e['epoch']}",
                      {k: v for k, v in e.items() if "@" in k})
    check_metrics(f"[{impl}] test", res["test_result"])
    if not res["test_result"]["recall@10"] > 0:
        raise AssertionError(f"[{impl}] test recall@10 is 0")
    n_evals = len(valids) + 1
    want = expected_train_counts(impl, steps, n_evals)
    log(f"[{impl}] train launches: {counts} (expected {want}: "
        f"{N_LAYERS} layers x ({EPOCHS} x {steps} steps forward and back "
        f"+ {n_evals} evaluations forward))")
    if counts != want:
        raise AssertionError(f"[{impl}] training launch counts differ")
    log(f"[{impl}] train peak device memory (max_memory_allocated): "
        f"{peak_bytes} bytes ({peak_bytes / 2**30:.3f} GiB)")

    ckpt = os.path.join(cd["checkpoint_dir"], "LightGCN-gowalla_shape.ckpt")
    state = load_checkpoint(ckpt)
    trainer = Trainer(config, model)
    it = iter(train_loader)
    host_batches = [next(it) for _ in range(5 + TIMED_STEPS + 10)]
    step_ms, prof = time_train_steps(trainer, model, state, host_batches, dev)
    log(f"[{impl}] train step (host clock, synchronised, {TIMED_STEPS} "
        f"steps after 5 warm-up): median {np.median(step_ms):.3f} ms, min "
        f"{min(step_ms):.3f}, max {max(step_ms):.3f}")
    log(f"[{impl}] train step profile (torch.profiler, 10 steps): "
        + (json.dumps(prof) if prof else "not measured (no device "
           "activity recorded)"))
    params = params_from_numpy(state["params"], dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = trainer.evaluator.evaluate(params, {}, valid_loader)
    eval_s = time.perf_counter() - t0
    log(f"[{impl}] full-sort evaluation of {len(valid_loader.eval_users)} "
        f"valid users x {model.n_items} items (host clock): {eval_s:.3f} s")
    # the checkpoint holds the best epoch's params: re-evaluating them
    # gives that epoch's validation result
    best = next(e for e in valids if e["epoch"] == int(state["best_epoch"]))
    for k, v in result.items():
        if not abs(v - best[k]) <= 1e-6:
            raise AssertionError(
                f"[{impl}] re-evaluation of the checkpoint: {k} {v} "
                f"differs from its epoch's validation {best[k]}")
    batch = to_device(next(iter(train_loader)), dev)
    step_err = step_vs_plain(model, params, batch, impl)
    log(f"[{impl}] step vs plain: " + ", ".join(
        f"{k} {v:.6e}" for k, v in step_err.items()))
    return {"config": config, "ckpt": ckpt, "model": model, "graph": graph,
            "params": params, "steps": steps, "counts": counts}


def serve_path(run: dict, tmp: str, impl: str, dev,
               batches=BATCHES) -> dict:
    """Export the trained checkpoint and serve it, every counter set to
    0 just before and read just after; the export must launch the
    impl's forward kernels once per layer, serving none."""
    from recbole_gnn_tpu_torch.ops.segment_spmm import spmm_coo
    from recbole_gnn_tpu_torch.serve import RecServer, export_artifact
    art = os.path.join(tmp, f"lightgcn-{impl}.npz")
    reset_counts()
    t0 = time.perf_counter()
    export_artifact(run["config"], art, checkpoint_path=run["ckpt"],
                    device=dev)
    export_s = time.perf_counter() - t0
    export_counts = read_counts()
    srv = RecServer(art, device=dev)
    rng = np.random.default_rng(SEED)
    latency = {}
    for b in batches:
        uids = rng.choice(np.arange(1, srv.n_users), b, replace=False)
        toks = [str(srv.user_tokens[u]) for u in uids]
        srv.recommend(toks, k=TOP_K)          # warm-up
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            idx, vals = srv.recommend(toks, k=TOP_K, return_tokens=False)
            times.append(time.perf_counter() - t0)
        latency[b] = float(np.median(times)) * 1e3
        with np.load(art, allow_pickle=False) as z:
            ref = (z["user_table"], z["item_table"]) if b <= 64 else None
        check_recommendations(srv, uids, idx, vals, ref)
    http_uids = rng.choice(np.arange(1, srv.n_users), 3, replace=False)
    out = http_roundtrip(srv, [str(srv.user_tokens[u])
                               for u in http_uids], TOP_K)
    tok2iid = {str(t): i for i, t in enumerate(srv.item_tokens)}
    http_idx = np.array([[tok2iid[t] for t in row] for row in out["items"]])
    check_recommendations(srv, http_uids, http_idx,
                          np.array(out["scores"], dtype=np.float32))
    counts = read_counts()
    log(f"[{impl}] export: {export_s:.2f} s, launches {export_counts}")
    log(f"[{impl}] recommend latency (ms, median of 5, k=10): "
        + ", ".join(f"B={b}: {ms:.2f}" for b, ms in latency.items()))
    log(f"[{impl}] http: {len(out['items'])} users answered")
    fwd = ("segment_spmm",) if impl == "pallas" else ("row_gather",
                                                      "block_segment_sum")
    want = {k: (N_LAYERS if k in fwd else 0) for k in counts}
    if export_counts != want or counts != want:
        raise AssertionError(
            f"[{impl}] serving launched {export_counts} in the export and "
            f"{counts} on the whole path; expected {want} for both")

    # the exported (trained) tables against a plain propagation
    graph, params = run["graph"], run["params"]
    with torch.inference_mode():
        h = torch.cat([params["user_emb"], params["item_emb"]])
        layers = [h]
        for _ in range(N_LAYERS):
            h = spmm_coo(graph.src, graph.dst, graph.weight, h,
                         graph.n_nodes)
            layers.append(h)
        final = torch.stack(layers).mean(0).cpu().numpy()
    with np.load(art, allow_pickle=False) as z:
        exported = np.concatenate([z["user_table"], z["item_table"]])
    table_err = float(np.abs(exported - final).max())
    log(f"[{impl}] export vs plain propagation: max_abs_err="
        f"{table_err:.3e} (max |table| {np.abs(final).max():.3e})")
    np.testing.assert_allclose(exported, final, rtol=1e-4, atol=1e-7)
    return counts


# -- main -------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from recbole_gnn_tpu_torch.diag import pallas_floor, row_gather as d2
    from recbole_gnn_tpu_torch.diag.timing import bound_by, bound_ms
    from recbole_gnn_tpu_torch.ops import cuda_build
    from recbole_gnn_tpu_torch.ops.gather import row_gather, row_gather_plain
    from recbole_gnn_tpu_torch.ops.segment_spmm import (
        segment_spmm, segment_spmm_transpose, spmm_coo)
    from recbole_gnn_tpu_torch.ops.segment_sum import (
        block_segment_sum, block_segment_sum_plain)
    from recbole_gnn_tpu_torch.ops.spmm import build_graph, xla_spmm

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 U·Iᵀ
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. build: one nvcc per source, all started at once
    t0 = time.perf_counter()
    build_log = cuda_build.build(SOURCES)
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(build_log) or 'already built'})")
    for name, text in build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 3. the slice's data
        t0 = time.perf_counter()
        write_gowalla_shape(tmp, "gowalla_shape", SEED, **GOWALLA_SHAPE)
        log(f"data written ({time.perf_counter() - t0:.1f} s)")

        # 4. the paths, each with the counters at 0 before it
        pallas = train_path(tmp, "pallas", dev)
        paths["pallas_train"] = pallas["counts"]
        paths["pallas_serve"] = serve_path(pallas, tmp, "pallas", dev)
        xla = train_path(tmp, "xla", dev)
        paths["xla_train"] = xla["counts"]
        paths["xla_serve"] = serve_path(xla, tmp, "xla", dev,
                                        batches=(1, 64))
        reset_counts()
        probe1 = pallas_floor.run("cuda")
        probe2 = d2.run("cuda")
        paths["probes"] = read_counts()
        for name, r in (("D1 block_segment_sum", probe1),
                        ("D2 row_gather", probe2)):
            log(f"probe {name} at the TPU probe's shape: "
                f"{json.dumps(r)}")
        graph, params, model = pallas["graph"], pallas["params"], \
            pallas["model"]
        steps = pallas["steps"]

        # 5. every kernel against its plain version: the slice shape,
        # then the edge cases
        with torch.inference_mode():
            gen = torch.Generator(device=dev).manual_seed(SEED)
            x = torch.cat([params["user_emb"], params["item_emb"]]).contiguous()
            cot = torch.randn(graph.n_nodes, EMBEDDING_SIZE, device=dev,
                              generator=gen)
            max_err, max_err_t = check_kernels("slice", graph, x, cot)
            xla_err = check_xla_kernels("slice", graph, x, cot)
            case_rng = np.random.default_rng(SEED + 1)
            for name, s, d_, w, n_dst, n_src, dim in edge_case_graphs(case_rng):
                g = build_graph(s, d_, w, n_dst, n_src, device=dev,
                                with_pallas=True, with_reverse=True)
                xc = torch.from_numpy(case_rng.normal(
                    size=(n_src, dim)).astype(np.float32)).to(dev)
                gc = torch.from_numpy(case_rng.normal(
                    size=(n_dst, dim)).astype(np.float32)).to(dev)
                check_kernels(name, g, xc, gc)
                errs = check_xla_kernels(name, g, xc, gc)
                if name in ("hub_rows", "rectangular", "multi_segment"):
                    errs = check_xla_kernels(f"{name} chunk={CHUNK}", g, xc,
                                             gc, chunk=CHUNK)
                for k, v in errs.items():
                    xla_err[k] = max(xla_err[k], v)
                del g, xc, gc

            # 6. times at the slice shape: K1, then K1T
            nnz, n = graph.nnz, graph.n_nodes
            kernel_ms = time_cuda_ms(lambda: segment_spmm(
                graph.src, graph.dst, graph.weight, graph.rowptr, x))
            plain_ms = time_cuda_ms(lambda: spmm_coo(
                graph.src, graph.dst, graph.weight, x, n))
            csr = sorted_csr(graph.dst[:nnz], graph.src[:nnz],
                             graph.weight[:nnz], n, graph.n_src_nodes)
            lib_err = float((torch.sparse.mm(csr, x) - spmm_coo(
                graph.src, graph.dst, graph.weight, x, n)).abs().max())
            library_ms = time_cuda_ms(lambda: torch.sparse.mm(csr, x))
            kernel_t_ms = time_cuda_ms(lambda: segment_spmm_transpose(
                graph.rev_src, graph.rev_dst, graph.rev_weight,
                graph.rev_rowptr, cot))
            plain_t_ms = time_cuda_ms(lambda: spmm_coo(
                graph.rev_src, graph.rev_dst, graph.rev_weight, cot,
                graph.n_src_nodes))
            csr_t = sorted_csr(graph.src[:nnz], graph.dst[:nnz],
                               graph.weight[:nnz], graph.n_src_nodes, n)
            lib_err_t = float((torch.sparse.mm(csr_t, cot) - spmm_coo(
                graph.rev_src, graph.rev_dst, graph.rev_weight, cot,
                graph.n_src_nodes)).abs().max())
            library_t_ms = time_cuda_ms(lambda: torch.sparse.mm(csr_t, cot))
            # the xla SpMM whole (D2, the weight product, D1)
            xla_ms = time_cuda_ms(lambda: xla_spmm(
                graph.src, graph.dst, graph.weight, graph.rowptr, x))
            xla_t_ms = time_cuda_ms(lambda: xla_spmm(
                graph.rev_src, graph.rev_dst, graph.rev_weight,
                graph.rev_rowptr, cot))
            del csr, csr_t

            # D2 and D1 at the slice shape, as the xla forward calls them
            d2_ms = time_cuda_ms(lambda: row_gather(x, graph.src))
            d2_plain_ms = time_cuda_ms(lambda: row_gather_plain(x, graph.src))
            d2_bytes, d2_flops = d2.work(x, graph.src)
            msgs = row_gather(x, graph.src) * graph.weight[:, None]
            d1_args = (msgs, graph.dst, graph.rowptr)
            d1 = {}
            for mode in D1_MODES:
                d1[mode] = {
                    "ms": time_cuda_ms(lambda: block_segment_sum(*d1_args,
                                                                 mode)),
                    "plain_ms": time_cuda_ms(lambda: block_segment_sum_plain(
                        *d1_args, mode))}
            acc = torch.zeros(n, EMBEDDING_SIZE, device=dev)
            d1_library_ms = time_cuda_ms(
                lambda: acc.index_add_(0, graph.dst, msgs))
            d1_bytes, d1_flops = pallas_floor.work(msgs, graph.rowptr)
            # the hub block alone: every other block's range made empty
            deg = (graph.rowptr[1:] - graph.rowptr[:-1]).cpu().numpy()
            tail = graph.n_edges_padded - nnz
            real = deg.copy()
            real[-1] -= tail
            hub = int(np.argmax(real))
            base = hub - hub % 64
            lo, hi = graph.rowptr[base], graph.rowptr[min(base + 64, n)]
            rp_hub = graph.rowptr.clamp(lo, hi)
            hub_edges = int(hi - lo)
            d1_hub_ms = time_cuda_ms(lambda: block_segment_sum(
                msgs, graph.dst, rp_hub, "f32"))
            del msgs, acc

            # where K1's time goes: one warp walks each row, so the
            # longest row (a Zipf hub item, or the padding tail) sets it
            rdeg = (graph.rev_rowptr[1:] - graph.rev_rowptr[:-1]).cpu().numpy()
            rp_unpadded = torch.clamp(graph.rowptr, max=nnz)
            unpadded_ms = time_cuda_ms(lambda: segment_spmm(
                graph.src, graph.dst, graph.weight, rp_unpadded, x))
            u = np.random.default_rng(SEED + 2)
            flat = build_graph(u.integers(0, n, nnz), u.integers(0, n, nnz),
                               np.ones(nnz, np.float32), n, device=dev,
                               with_reverse=False)
            uniform_ms = time_cuda_ms(lambda: segment_spmm(
                flat.src, flat.dst, flat.weight, flat.rowptr, x))
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.propagate(params, model.consts, {})
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
    log(f"slice degrees: max real {int(real.max())} (row {hub}, D1 block "
        f"{hub // 64} holds {hub_edges} edges), padding tail {tail} on row "
        f"{n - 1} (real degree {int(real[-1])}); transpose: max "
        f"{int(rdeg.max())}, row 0 holds {int(rdeg[0])} (the padding), "
        f"mean {nnz / n:.1f}")
    log(f"segment_spmm diagnostics: without the padding tail "
        f"{unpadded_ms:.4f} ms; uniform random graph of the same "
        f"n and nnz {uniform_ms:.4f} ms (max degree "
        f"{int((flat.rowptr[1:] - flat.rowptr[:-1]).max())}); "
        f"LightGCN propagate ({N_LAYERS} layers, host clock) "
        f"{np.median(times) * 1e3:.3f} ms")
    e_pad = graph.n_edges_padded
    n_bytes, flops = spmm_bytes(n, graph.n_src_nodes, e_pad, n + 1,
                                EMBEDDING_SIZE)
    n_bytes_t, flops_t = spmm_bytes(graph.n_src_nodes, n, e_pad,
                                    graph.n_src_nodes + 1, EMBEDDING_SIZE)
    bound, bound_t = bound_ms(n_bytes, flops), bound_ms(n_bytes_t, flops_t)
    log(f"segment_spmm (K1) at the slice shape: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, torch.sparse.mm {library_ms:.4f} ms "
        f"(max_abs_err vs plain {lib_err:.3e}), bound {bound:.4f} ms "
        f"({n_bytes} bytes, {flops} flops)")
    log(f"segment_spmm_transpose (K1T) at the slice shape: kernel "
        f"{kernel_t_ms:.4f} ms, plain {plain_t_ms:.4f} ms, "
        f"torch.sparse.mm {library_t_ms:.4f} ms (max_abs_err vs plain "
        f"{lib_err_t:.3e}), bound {bound_t:.4f} ms ({n_bytes_t} "
        f"bytes, {flops_t} flops); {N_LAYERS} launches per step, "
        f"{N_LAYERS * steps} per epoch")
    d2_bound = bound_ms(d2_bytes, d2_flops)
    d1_bound = bound_ms(d1_bytes, d1_flops)
    log(f"xla SpMM (D2 + weight product + D1) at the slice shape: forward "
        f"{xla_ms:.4f} ms, transpose {xla_t_ms:.4f} ms (bound of the "
        f"composition as one SpMM {bound:.4f} ms)")
    log(f"row_gather (D2) at the slice shape ({e_pad} rows of "
        f"{graph.n_src_nodes} x {EMBEDDING_SIZE}): kernel {d2_ms:.4f} ms, "
        f"plain = index_select {d2_plain_ms:.4f} ms, bound {d2_bound:.4f} ms "
        f"({d2_bytes} bytes)")
    log(f"block_segment_sum (D1) at the slice shape ({e_pad} x "
        f"{EMBEDDING_SIZE} messages into {n} rows): bound {d1_bound:.4f} ms "
        f"({d1_bytes} bytes), index_add_ {d1_library_ms:.4f} ms; "
        + "; ".join(f"{m} kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f}"
                    for m, r in d1.items())
        + f"; the hub block alone ({hub_edges} edges) {d1_hub_ms:.4f} ms")
    log(f"launches by path: {json.dumps(paths)}")

    def by_path(k):
        return {p: c[k] for p, c in paths.items()}

    print(json.dumps({"kernels": [
        {"name": "segment_spmm", "route": "cuda",
         "source": "recbole_gnn_tpu_torch/csrc/segment_spmm.cu",
         "replaces": "recbole_gnn_tpu/ops/pallas_spmm.py:227",
         "replaces_function": "_spmm_kernel",
         "launches": paths["pallas_train"]["segment_spmm"]
         + paths["pallas_serve"]["segment_spmm"],
         "launches_by_path": by_path("segment_spmm"),
         "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
         "bound_ms": bound, "bound_by": bound_by(n_bytes, flops),
         "library_ms": library_ms},
        {"name": "segment_spmm_transpose", "route": "cuda",
         "source": "recbole_gnn_tpu_torch/csrc/segment_spmm.cu",
         "replaces": "recbole_gnn_tpu/ops/spmm.py:339",
         "replaces_function": "_spmm_core_bwd (pallas_spmm over rev_*)",
         "launches": paths["pallas_train"]["segment_spmm_transpose"],
         "launches_by_path": by_path("segment_spmm_transpose"),
         "max_abs_err": max_err_t, "ms": kernel_t_ms,
         "plain_ms": plain_t_ms, "bound_ms": bound_t,
         "bound_by": bound_by(n_bytes_t, flops_t),
         "library_ms": library_t_ms},
        {"name": "row_gather", "route": "cuda",
         "source": "recbole_gnn_tpu_torch/csrc/row_gather.cu",
         "replaces": "scripts/diag/r3_sparse_probe4.py:98",
         "replaces_function": "case_q.kernel",
         "launches": paths["xla_train"]["row_gather"]
         + paths["xla_serve"]["row_gather"],
         "launches_by_path": by_path("row_gather"),
         "max_abs_err": xla_err["row_gather"], "ms": d2_ms,
         "plain_ms": d2_plain_ms, "bound_ms": d2_bound,
         "bound_by": bound_by(d2_bytes, d2_flops), "library_ms": d2_plain_ms,
         "probe_shape": {k: probe2[k] for k in
                         ("ms", "plain_ms", "bound_ms", "library_ms")}},
        {"name": "block_segment_sum", "route": "cuda",
         "source": "recbole_gnn_tpu_torch/csrc/segment_sum.cu",
         "replaces": "scripts/diag/pallas_floor.py:16",
         "replaces_function": "make_kernel",
         "launches": paths["xla_train"]["block_segment_sum"]
         + paths["xla_serve"]["block_segment_sum"],
         "launches_by_path": by_path("block_segment_sum"),
         "max_abs_err": xla_err["block_segment_sum"], "ms": d1["f32"]["ms"],
         "plain_ms": d1["f32"]["plain_ms"], "bound_ms": d1_bound,
         "bound_by": bound_by(d1_bytes, d1_flops),
         "library_ms": d1_library_ms,
         "modes_ms": {m: r["ms"] for m, r in d1.items()},
         "probe_shape": {"bound_ms": probe1["bound_ms"],
                         "library_ms": probe1["library_ms"],
                         "modes": probe1["modes"]}},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
