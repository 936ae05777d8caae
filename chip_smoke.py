"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``recbole_gnn_tpu_torch/csrc``,
holds it against its plain PyTorch version at the serving path's shape
and at edge-case shapes, then drives the serving path end to end
through the entry points a user calls: LightGCN at its published width
(embedding_size 64, 3 layers) on a seeded synthetic dataset of the
LightGCN paper's Gowalla shape (29,858 users × 40,981 items, 1,027,370
interactions), a checkpoint with seeded random weights, ``export_artifact``
on the card, ``RecServer`` for batches of 1/8/64/1024 users and one
HTTP request.

Prints the card's name and power limit, the build, timing and check
lines, then a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Exits non-zero without a result
when there is no CUDA device or any check fails.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import json
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
# the LightGCN paper's Gowalla statistics (He et al., 2020, Table 1)
GOWALLA_SHAPE = {"n_users": 29858, "n_items": 40981, "n_inter": 1027370}
BATCHES = (1, 8, 64, 1024)
TOP_K = 10

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 non-tensor rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# |kernel − plain| ≤ TOL_REL_ABSSUM · Σ_e |w_e·x[src_e]| elementwise:
# both sum the same f32 terms in another order, so their difference is
# bounded by a multiple of the unit roundoff times the sum of absolute
# terms (empty rows must match exactly: both write 0)
TOL_REL_ABSSUM = 1e-4


def log(msg: str):
    print(msg, flush=True)


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


# -- timing ---------------------------------------------------------------

def time_cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each timed
    with CUDA events after a write of 256 MB that evicts the 50 MB L2
    (the export's layers find their inputs cold at this size too)."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def spmm_bound_ms(graph, d: int) -> tuple[float, int, int]:
    """Least time for one SpMM over ``graph`` at width ``d``: the larger
    of bytes moved (x read once, out written once, src/weight/rowptr
    read once) over HBM bandwidth and 2·E·d flops over the fp32 rate."""
    n_bytes = (graph.n_src_nodes * d * 4 + graph.n_nodes * d * 4
               + graph.src.numel() * 4 + graph.weight.numel() * 4
               + graph.rowptr.numel() * 8)
    flops = 2 * graph.src.numel() * d
    return (max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
            n_bytes, flops)


# -- kernel vs plain ------------------------------------------------------

def check_kernel(name: str, graph, x: torch.Tensor) -> float:
    """Kernel vs plain version on the same inputs; returns max |err|."""
    from recbole_gnn_tpu_torch.ops.segment_spmm import segment_spmm, spmm_coo
    got = segment_spmm(graph.src, graph.dst, graph.weight, graph.rowptr, x)
    want = spmm_coo(graph.src, graph.dst, graph.weight, x, graph.n_nodes)
    abssum = spmm_coo(graph.src, graph.dst, graph.weight.abs(), x.abs(),
                      graph.n_nodes)
    torch.cuda.synchronize()
    err = (got - want).abs()
    excess = float((err - TOL_REL_ABSSUM * abssum).max())
    max_err = float(err.max())
    log(f"kernel check {name}: n={graph.n_nodes} e_pad={graph.src.numel()} "
        f"d={x.shape[1]} max_abs_err={max_err:.3e} "
        f"empty_rows={int((graph.rowptr[1:] == graph.rowptr[:-1]).sum())}")
    if not (excess <= 0.0 and torch.isfinite(got).all()):
        raise AssertionError(
            f"segment_spmm disagrees with spmm_coo on {name}: max_abs_err "
            f"{max_err:.3e} exceeds {TOL_REL_ABSSUM} x sum|w x| by {excess:.3e}")
    return max_err


def edge_case_graphs(rng: np.random.Generator):
    """(name, src, dst, w, n, d) of the CPU tests' edge cases."""
    cases = []
    n, e = 200_000, 3_000_000                       # several 2^20 segments
    cases.append(("multi_segment", rng.integers(0, n, e),
                  rng.integers(0, n, e), n, 64))
    n, e = 5000, 20000                              # empty rows incl. PAD 0
    cases.append(("empty_rows", rng.integers(0, n, e),
                  2 * rng.integers(1, n // 4, e), n, 64))
    n, e = 1000, 5000                               # block-overrun shape
    cases.append(("overrun", rng.integers(0, n, e), rng.integers(0, n, e),
                  n, 64))
    n, e = 3000, 30000
    cases.append(("d48", rng.integers(0, n, e), rng.integers(0, n, e), n, 48))
    cases.append(("d33_scalar", rng.integers(0, n, e),
                  rng.integers(0, n, e), n, 33))
    cases.append(("d130_vec2_two_passes", rng.integers(0, n, e),
                  rng.integers(0, n, e), n, 130))
    cases.append(("d256_vec4_two_passes", rng.integers(0, n, e),
                  rng.integers(0, n, e), n, 256))
    n, e = 20000, 400_000                           # Zipf hub rows
    cases.append(("hub_rows", rng.integers(0, n, e),
                  (rng.zipf(1.3, e) - 1) % n, n, 64))
    return [(nm, s, d_, rng.normal(size=len(s)).astype(np.float32), n_, dim)
            for nm, s, d_, n_, dim in cases]


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


# -- main -------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.models import get_model
    from recbole_gnn_tpu_torch.ops import cuda_build
    from recbole_gnn_tpu_torch.ops.segment_spmm import segment_spmm, spmm_coo
    from recbole_gnn_tpu_torch.ops.spmm import build_graph
    from recbole_gnn_tpu_torch.quick_start import create_dataset
    from recbole_gnn_tpu_torch.serve import RecServer, export_artifact
    from recbole_gnn_tpu_torch.train.checkpoint import save_checkpoint
    from recbole_gnn_tpu_torch.utils.seed import init_seed

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 U·Iᵀ
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    build_log = cuda_build.build(["segment_spmm"])
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(build_log) or 'already built'})")
    for name, text in build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 3. the slice's data, model and checkpoint
        t0 = time.perf_counter()
        write_gowalla_shape(tmp, "gowalla_shape", SEED, **GOWALLA_SHAPE)
        config = Config(model="LightGCN", dataset="gowalla_shape",
                        config_dict={"data_path": tmp, "checkpoint_dir": tmp,
                                     "embedding_size": EMBEDDING_SIZE,
                                     "n_layers": N_LAYERS,
                                     "enable_sparse": True,
                                     "sparse_spmm_impl": "pallas",
                                     "seed": SEED, "state": "ERROR"})
        train_ds, _, _ = create_dataset(config).build()
        model = get_model("LightGCN")(config, train_ds, dev)
        params = model.init_params(init_seed(SEED))
        ckpt = os.path.join(tmp, "LightGCN-gowalla_shape.ckpt")
        save_checkpoint(ckpt, {"params": params, "extras": {},
                               "epoch": np.int64(0),
                               "config": {"model": "LightGCN",
                                          "dataset": "gowalla_shape"}})
        graph = model.consts["graph"]
        log(f"data: {train_ds} -> graph n={graph.n_nodes} nnz={graph.nnz} "
            f"e_pad={graph.n_edges_padded} ({time.perf_counter() - t0:.1f} s)")

        # 4. the main path: export on the card, then serve
        art = os.path.join(tmp, "lightgcn.npz")
        segment_spmm.launches = 0
        t0 = time.perf_counter()
        export_artifact(config, art, checkpoint_path=ckpt, device=dev)
        export_s = time.perf_counter() - t0
        export_launches = segment_spmm.launches
        srv = RecServer(art, device=dev)
        rng = np.random.default_rng(SEED)
        latency = {}
        for b in BATCHES:
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
        path_launches = segment_spmm.launches
        log(f"export: {export_s:.2f} s, segment_spmm launches {export_launches}")
        log("recommend latency (ms, median of 5, k=10): "
            + ", ".join(f"B={b}: {ms:.2f}" for b, ms in latency.items()))
        log(f"http: {len(out['items'])} users answered")
        if export_launches != N_LAYERS or path_launches != N_LAYERS:
            raise AssertionError(
                f"segment_spmm launched {export_launches} times in the "
                f"export and {path_launches} on the whole path; "
                f"expected {N_LAYERS} (one per layer)")

        # the exported tables against a plain propagation on the card
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
        log(f"export vs plain propagation: max_abs_err={table_err:.3e} "
            f"(max |table| {np.abs(final).max():.3e})")
        np.testing.assert_allclose(exported, final, rtol=1e-4, atol=1e-7)

        # 5. kernel vs plain: the slice shape, then the edge cases
        with torch.inference_mode():
            x = torch.cat([params["user_emb"], params["item_emb"]]).contiguous()
            max_err = check_kernel("slice", graph, x)
            case_rng = np.random.default_rng(SEED + 1)
            for name, s, d_, w, n, dim in edge_case_graphs(case_rng):
                g = build_graph(s, d_, w, n, device=dev, with_pallas=True,
                                with_reverse=False)
                xc = torch.from_numpy(
                    case_rng.normal(size=(n, dim)).astype(np.float32)).to(dev)
                check_kernel(name, g, xc)

            # times at the slice shape
            kernel_ms = time_cuda_ms(lambda: segment_spmm(
                graph.src, graph.dst, graph.weight, graph.rowptr, x))
            plain_ms = time_cuda_ms(lambda: spmm_coo(
                graph.src, graph.dst, graph.weight, x, graph.n_nodes))
            # the yardstick's CSR holds the real edges only, columns
            # sorted within each row (cuSPARSE's invariants; the padding
            # edges are weight-0 duplicates and add nothing)
            nnz = graph.nnz
            key = (graph.dst[:nnz].long() * graph.n_src_nodes
                   + graph.src[:nnz].long())
            order = torch.argsort(key)
            warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
            csr = torch.sparse_csr_tensor(
                torch.clamp(graph.rowptr, max=nnz),
                graph.src[:nnz].long()[order], graph.weight[:nnz][order],
                size=(graph.n_nodes, graph.n_src_nodes), check_invariants=True)
            lib_err = float((torch.sparse.mm(csr, x) - spmm_coo(
                graph.src, graph.dst, graph.weight, x, graph.n_nodes)
                ).abs().max())
            library_ms = time_cuda_ms(lambda: torch.sparse.mm(csr, x))

            # where the kernel's time goes: one warp walks each row, so
            # the longest row (a Zipf hub item, or the last row with the
            # weight-0 padding tail) sets the time
            deg = (graph.rowptr[1:] - graph.rowptr[:-1]).cpu().numpy()
            tail = graph.n_edges_padded - graph.nnz
            real = deg.copy()
            real[-1] -= tail
            rp_unpadded = torch.clamp(graph.rowptr, max=graph.nnz)
            unpadded_ms = time_cuda_ms(lambda: segment_spmm(
                graph.src, graph.dst, graph.weight, rp_unpadded, x))
            u = np.random.default_rng(SEED + 2)
            flat = build_graph(u.integers(0, graph.n_nodes, graph.nnz),
                               u.integers(0, graph.n_nodes, graph.nnz),
                               np.ones(graph.nnz, np.float32), graph.n_nodes,
                               device=dev, with_reverse=False)
            uniform_ms = time_cuda_ms(lambda: segment_spmm(
                flat.src, flat.dst, flat.weight, flat.rowptr, x))
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.propagate(params, model.consts, {})
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        log(f"slice degrees: max real {int(real.max())}, padding tail "
            f"{tail} on row {graph.n_nodes - 1} (real degree {int(real[-1])}),"
            f" mean {graph.nnz / graph.n_nodes:.1f}")
        log(f"segment_spmm diagnostics: without the padding tail "
            f"{unpadded_ms:.4f} ms; uniform random graph of the same "
            f"n and nnz {uniform_ms:.4f} ms (max degree "
            f"{int((flat.rowptr[1:] - flat.rowptr[:-1]).max())}); "
            f"LightGCN propagate ({N_LAYERS} layers, host clock) "
            f"{np.median(times) * 1e3:.3f} ms")
        bound_ms, n_bytes, flops = spmm_bound_ms(graph, x.shape[1])
        log(f"segment_spmm at the slice shape: kernel {kernel_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, torch.sparse.mm {library_ms:.4f} ms "
            f"(max_abs_err vs plain {lib_err:.3e}), bound {bound_ms:.4f} ms "
            f"({n_bytes} bytes, {flops} flops)")

    print(json.dumps({"kernels": [{
        "name": "segment_spmm",
        "route": "cuda",
        "source": "recbole_gnn_tpu_torch/csrc/segment_spmm.cu",
        "replaces": "recbole_gnn_tpu/ops/pallas_spmm.py:227",
        "replaces_function": "_spmm_kernel",
        "launches": path_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if n_bytes / HBM_BYTES_PER_S
        >= flops / FP32_FLOPS else "operations",
        "library_ms": library_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
