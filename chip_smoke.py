"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's five CUDA sources from ``recbole_gnn_tpu_torch/csrc``
(one ``nvcc`` each, all at once) and drives the port's paths end to end
through the entry points a user calls, on a seeded synthetic dataset of
the LightGCN paper's Gowalla shape (29,858 users × 40,981 items,
1,027,370 interactions) with LightGCN at its published width
(embedding_size 64, 3 layers) on the sparse graph:

1. ``sparse_spmm_impl: ell`` (the config's default) training:
   ``run_recbole_gnn_tpu`` for 1 epoch — 415 steps of 2,048 pairs,
   every step 3 forward SpMMs (K2, ``ell_spmm``, the bucketed-ELL
   kernel) and, in the backward, 3 transpose SpMMs (K2ᵀ, the same kernel
   over the transpose layout) — with full-sort validation, a checkpoint
   and the test evaluation; the loss of a fixed batch must fall from
   the initial params to the trained ones (on every LightGCN-family
   path);
2. ``ell`` serving: ``export_artifact`` from that checkpoint, then
   ``RecServer`` for batches of 1/8/64/1024 users and one HTTP request;
3. ``sparse_spmm_impl: pallas`` training, 100 steps of the epoch
   (``capped_train_steps``, a logged depth cut, as for xla, SimGCL and
   XSimGCL), every SpMM K1 (``segment_spmm``) forward and K1ᵀ back, and
   its serving;
4. ``sparse_spmm_impl: xla`` training, 100 steps, every SpMM made of the
   row gather (D2, ``row_gather``) and the block segment sum (D1,
   ``block_segment_sum``), forward and backward, and its serving;
5. SimGCL (9 K2 forward and 9 K2ᵀ per step: an unperturbed and two
   perturbed propagations) and XSimGCL (3 and 3) on ``ell``, 100 steps
   each, at the same shape and width;
6. the probes: D1 and D2 at the shapes of the TPU probes they replace
   (``recbole_gnn_tpu_torch.diag.pallas_floor`` / ``.row_gather``);
7. after every kernel check below, the general family on
   ``ell`` (in a child process of the script, ``--general``), each
   model through
   ``run_recbole_gnn_tpu`` at its published yaml settings for 1 epoch
   of 50 steps (HMLET 2 whole epochs): per step K2 forward / K2ᵀ back SGL 9 / 9 (the graph and
   two augmented views, 3 layers each; each view's ELL layouts and their
   kernel arguments made once per epoch, checked through
   ``_layout_args.builds``) and 2 / 2 calls of the InfoNCE pair
   (``nce_lse`` forward / ``nce_lse_grad`` back: users and items), NCL
   3 / 3 and 4 / 4 of the pair (two layer terms, two ProtoNCE terms),
   NGCF 3 / 3, HMLET 6 / 6 (4
   layers, gates at 2 and 3), LightGCL 4 / 4 (2 layers over its
   rectangular graphs), DirectAU with the LightGCN encoder 3 / 3,
   NeuMF and SSL4REC none; the deliberate overrides (NCL
   ``warm_up_step: 0``, HMLET ``warm_up_epochs: 0``, DirectAU
   ``encoder: LightGCN``) are logged with their reasons.  Each graph
   model's step is held against the same step on plain SpMMs and, for
   SGL and NCL, the plain InfoNCE (``nce_lse_plain``: cuBLAS f32 and
   ``torch.logsumexp``), and so
   are NGCF with ``node_dropout: 0.1`` (its re-weighted graph runs D2
   and D1) and LightGCL on ``pallas`` (K1 and K1ᵀ); SGL is exported
   and served, and NeuMF's export must refuse; then SGL with
   ``activation_dtype: bfloat16`` (the propagations on bf16 rows: K2
   and K2ᵀ in their bf16-x mode) the same way, 50 steps on ``ell`` with
   the same counts, its step held against its plain step (the plain
   versions with the same bf16 rounding, at the CPU parity tests'
   bounds: loss rtol 1e-2, each gradient leaf's max |Δ| within 3e-2 of
   max|g| and its norm within 2e-2), its test ndcg@10 and recall@10
   within 0.02 of the f32 run's, its peak memory beside the f32 run's,
   exported and served; and 2 steps each on ``pallas`` in ``f32x2`` (K1
   on the bf16 first layer, f32 after it: 9 K1 / 9 K1ᵀ per step), on
   ``xla`` (D2 and D1 on bf16 rows: 18 / 18) and on the dense graph (no
   kernel; its tables equal, within 1e-6, those of the f32 model from
   the bf16-rounded embeddings: JAX's promotion of the first product to
   f32), each held against its plain step;
8. the session family (in a child process, ``--session``) on a
   seeded synthetic log of the reference's diginetica setting (72,014
   sessions × 29,454 items × 580,490 clicks,
   ``recbole_gnn_tpu_torch.diag.diginetica_shape``) at
   ``examples/diginetica.yaml``'s settings (``MAX_ITEM_LIST_LENGTH`` 20,
   5-core, batch 4,096, evaluation batch 2,000): the C++ session-graph
   builder must load and equal the numpy path on the whole dataset;
   SRGNN, NISER, TAGNN, GCSAN, SGNNHN, GRU4Rec, NARM, SASRec, GCEGNN and
   LESSR each train one epoch (TAGNN 30 steps of it, LESSR 45) through
   ``run_recbole_gnn_tpu`` at their
   yaml (each dataset class's build time logged; no kernel of the port
   runs on that dense path: every count must stay 0), the CE of a fixed
   batch must fall from the initial params to the trained ones, the
   metrics be finite (SRGNN's Recall@10 > 0), one step on the card
   (the batch's first 512 sessions) equal the same step on the CPU
   (loss rtol 1e-4, every gradient
   within 1e-4 of the step's largest, the logits within 1e-4 of theirs;
   dropout masks drawn on the card and replayed, and LESSR's PReLU
   branches, at most ``SESSION_STEP_MAX_FLIPS`` of them crossing 0
   between the devices); SRGNN, SASRec, GCEGNN
   and LESSR are served by ``SessionServer`` from their checkpoints
   (top-k against the evaluator's on 512 test sessions, ``recommend``
   p50/p99 at B = 1, 8, 64, 256, one HTTP round trip; LESSR's
   calibrated scores of one session the same at B = 1 and B = 256); and
   the sparse SR-GNN cell runs over one training batch's disjoint-union
   session graph on ``ell`` (2 K2 + 2 K2ᵀ) and ``pallas`` (2 K1 +
   2 K1ᵀ), held against the dense cell;
9. the social family (in a child process, ``--social``) on a
   seeded synthetic log of the HetRec 2011 LastFM statistics (1,892
   users × 17,632 artists, 92,834 pairs, 12,717 friend pairs,
   ``recbole_gnn_tpu_torch.diag.lastfm_shape``) at
   ``examples/lastfm.yaml``'s settings with ``enable_sparse: True``
   (SEPT ``warm_up_epochs: 0``; the overrides logged with their
   reasons): DiffNet, MHCN and SEPT (2 epochs) train through
   ``run_recbole_gnn_tpu`` on ``ell`` (K2 / K2ᵀ per step 3 / 3, 13 / 13
   and 8 / 8; their layouts' kernel arguments made once per matrix and,
   for SEPT's subgraph, once per epoch) and DiffNet also on ``pallas``
   (K1) and ``xla`` (D2 + D1), every count exact; each model's step on
   the kernels is held against the plain step and against its dense
   form's step (cuBLAS), DiffNet's also on ``pallas`` and ``xla``; MHCN
   is exported and served by ``RecServer``, its tables against a plain
   propagation and its top-k against theirs (``eval_batch_size`` as the
   yaml sets it: the evaluator scores each batch's real users in chunks
   under its byte budget);
10. last, the parallel paths (in a child process, ``--parallel``; it
   runs alone the same way, writing its data and building the kernels
   itself), on the LightGCN ``ell`` path at the slice shape: (iii) the
   edge-sharded K2/K2ᵀ — all 4 dst-block shards of the 1,696,528 edges
   in this process — their forward blocks and summed transpose shares
   held against unsharded K2/K2ᵀ within TOL_REL_ABSSUM, with each
   shard's edges and the imbalance (max/mean); (i) ``python -m
   recbole_gnn_tpu_torch.run --distributed`` (its
   ``main``, torchrun's environment for a world of one,
   ``--mesh_shape=[1] --graph_edge_sharding=True``) on NCCL against the
   same run without it: the same launches, test metrics within 1e-3,
   params within rtol 5e-4 / atol 5e-5; (ii) four gloo ranks that share
   the card (``--parallel-rank``; NCCL puts no two ranks of one
   communicator on one device), a ``{dp: 2, tp: 2}`` fit of 10 steps on
   the edge-sharded graph from one checkpoint, then validation, against
   the single-process fit on the card: each rank's launches exact,
   params and metrics within the same tolerances.

Each path runs with every launch counter set to 0 just before it and
read just after, and the counts are checked exactly.  A training step
replayed from its CUDA graph (``train/step_graph.py``) launches through
no wrapper: the counters hold the kernels of the eager steps and of
each capture, which the program's step counters give (``read_steps``),
and the replayed steps are logged apart.  Then it holds one
LightGCN training step of each impl on the kernels against the same
step on the plain versions, and every kernel against its plain version
at the slice shape and at edge-case shapes (a giant row, rows and empty
rows that sit on share boundaries, rows on ELL bucket boundaries,
isolated nodes, one row, forced edge chunks): K2 and K2ᵀ against
``ell_spmm_plain``, the sums of each row's real slots
(``ell_spmm_pad_free_plain``) and ``spmm_coo``, and on three cases of
their own (an input above half the L2; a non-finite row 0, which pad
slots multiply by 0; a zero-weight real edge from a non-finite row), K1
and K1ᵀ in ``bf16`` and
``packed`` against ``segment_spmm_plain``, every kernel in its
bf16-x mode (``activation_dtype: bfloat16``; K2, K2ᵀ, K1 and K1ᵀ in
each precision, D2 bit for bit, D1 with the weight, new, ``out=``,
``rowptr[0] != 0`` and a row pointer holding only the row with the most
edges, also against its share schedule and rerun bit for bit, and the
xla SpMM) against its bf16-x plain version
on bf16 copies of the inputs, within one bf16 unit of the plain value
(2⁻⁷·|plain|) plus 1e-4·Σ|term|, K1 and K1ᵀ also
against their share schedule in plain torch
(``segment_spmm_shares_plain``), D1 in all four modes and in f32 with
the edge weight that the xla path sums inside it, also against its
share schedule (``block_segment_sum_shares_plain``), with a row pointer
that does not start at 0 and accumulating into ``out``; the small edge
cases (among them D = 36, whose 72-byte bf16 rows D1 stages by cp.async
rather than TMA) at share size 1 too (``SHARE_CHECKED``), K1's and
D1's redesigned instances (K1 ``bf16`` and ``packed`` on f32 and bf16
x, D1 on bf16 messages) included.  It reruns K1 in every precision on
f32 and bf16 x, K1ᵀ in every precision, K2, K2ᵀ and D1 (f32 and bf16
messages) at the slice shape for bit equality, and checks from the
profiler that one call of K1, K1ᵀ, D1 (share pass and carry pass), K2
and K2ᵀ (row pass and combine pass) runs exactly two device kernels.
The InfoNCE pair (``csrc/info_nce.cu``) is held against its plain
version in float64 at SGL's two shapes (2,048 × 29,859 and 2,048 ×
40,982), an NCL centroid shape (2,048 × 1,000), all at d = 64, and at
2,048 × 29,859 with d = 128 (the kernels' wider instance): lse within
4e-6, dv1 and dav2 within 5e-6 of their largest entry (the card tests'
bounds, ``tests/test_torch_nce.py``), one forward and one backward
launch a call, a rerun bit for bit, and a forward call runs exactly two
device kernels.
The build prints each kernel's registers and spills (``-Xptxas=-v``).

Prints the card's name and power limit, the build and check lines, the
launches by path and, last, ``{"ok": true, "device": {...}}``.  Exits
non-zero without a result when there is no CUDA device or any check
fails.  Imports nothing of JAX or of the JAX package.  The port's
times on the card are ``portbench``'s (``BENCHMARK.json``).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

SEED = 2020
N_LAYERS = 3
EMBEDDING_SIZE = 64
# propagations per training step (each N_LAYERS SpMMs forward and back)
PROPAGATIONS = {"LightGCN": 1, "XSimGCL": 1, "SimGCL": 3}
BATCHES = (1, 8, 64, 1024)
TOP_K = 10
# the depth cut to keep the whole script near half its 1,200 s limit,
# each logged with its reason when main starts (no check is cut)
# training steps of the paths whose epoch is cut (the launch counts and
# every check follow the steps taken)
FAMILY_TRAIN_STEPS = 100       # pallas, xla, SimGCL, XSimGCL (ell: 415)
GENERAL_TRAIN_STEPS = 50       # the general family (415; DirectAU 3,314)
# HMLET keeps its 2 epochs: after 2 × 50 steps its step-vs-plain gradient
# error sat at the check's bound (2.64e-7 against 1.5e-7 with max|g|
# 1.09e-3, where the full epochs leave it well inside)
GENERAL_FULL_EPOCHS = ("HMLET",)
# the session models whose epoch of 89 steps is cut (the others' CE
# falls too little in 30 steps: GCEGNN's rose, 10.304 → 10.322)
SESSION_TRAIN_STEPS = {"TAGNN": 30, "LESSR": 45}
SESSION_STEP_ROWS = 512        # the card-vs-CPU session step's sessions
DEPTH_CUTS = (
    "LightGCN on ell trains 1 epoch, not 2: the loss's fall is held on a "
    "fixed batch (initial against trained params) on every LightGCN-"
    "family path instead",
    "SessionServer latency from 50 requests per batch size (20 at "
    "B = 256), not 100 (40)",
    f"pallas, xla, SimGCL and XSimGCL train {FAMILY_TRAIN_STEPS} steps, "
    "not the epoch's 415 (LightGCN on ell, the main path, keeps its "
    "epoch); the loss's fall on the fixed batch is held as before",
    f"the general family but HMLET trains {GENERAL_TRAIN_STEPS} steps per "
    "epoch, not 415 (DirectAU 3,314 of 256): every count, step check "
    "and evaluation as before",
    "TAGNN and LESSR train " + " and ".join(
        map(str, SESSION_TRAIN_STEPS.values())) + " steps, not the epoch's "
    "89 (TAGNN's took 15.3 s, LESSR's 8.3 s); the CE's fall on the fixed "
    "batch is held as before",
    f"SGL with activation_dtype: bfloat16 trains {GENERAL_TRAIN_STEPS} "
    "steps on ell, as the general family; on pallas, xla and the dense "
    "graph it takes 2 held steps each, not an epoch",
    f"the session card-vs-CPU step runs the batch's first "
    f"{SESSION_STEP_ROWS} sessions, not 4,096 (the CPU side of TAGNN's "
    "and LESSR's steps dominated the phase)")
SOURCES = ("segment_spmm", "row_gather", "segment_sum", "ell_spmm",
           "info_nce")
K1_MODES = ("bf16", "packed")   # K1's precisions besides f32x2
CHUNK = 100_003            # the forced xla chunk: boundaries inside rows

# |kernel − plain| ≤ TOL_REL_ABSSUM · Σ_e |term_e| elementwise: both sum
# the same f32 terms in another order, so their difference is bounded by
# a multiple of the unit roundoff times the sum of absolute terms (empty
# rows must match exactly: both write 0).  D2 must match bit for bit.
TOL_REL_ABSSUM = 1e-4
# a bf16-x kernel against its bf16-x plain version: the same f32 sums in
# another order, then one bf16 rounding of the output each, which may
# land on the two sides of a rounding boundary: one bf16 unit in the last
# place apart, at most 2⁻⁷ of the value (2⁻⁸ is half a unit, the bound
# of one rounding against the exact sum, which a value just above a
# power of two exceeds when the two round apart; on an H100 two K2
# results near 2 read 1.56e-2 apart):
# |Δ| ≤ BF16_TOL_REL·|plain| + TOL_REL_ABSSUM·Σ|term|
BF16_TOL_REL = 2.0 ** -7

# K1's and D1's share sizes checked on the small edge cases (None: each
# module's SHARE_EDGES, through the public wrapper, the only size
# checked at the slice shape and on the large cases)
SHARE_CHECKED = (1, None)
SMALL_CASE_EDGES = 1_000_000

# one training step, kernel against plain: the same f32 sums in another
# order through 3 layers forward and 3 back, plus the atomics of
# PyTorch's own gather backward (final[user]), whose bits change from
# run to run.  Gradients: |Δ| ≤ STEP_RTOL·|g| + STEP_ATOL_FRAC·max|g|
# (the atol covers entries that cancel toward 0); the loss: STEP_RTOL.
STEP_RTOL = 1e-4
STEP_ATOL_FRAC = 1e-5
# the general family's step: its contrastive terms pass the SpMM outputs
# through exp(cos / tau) with tau down to 0.1 (NCL), which multiplies
# the sum-order differences of the embeddings by up to 1 / tau = 10 in
# the gradients (NCL's read 1.3e-5 of max|g| on an H100)
GENERAL_STEP_ATOL_FRAC = 1e-4
# an activation_dtype: bfloat16 step against its plain step (the same
# bf16 roundings, but an f32 sum order that can put an output or a
# cotangent on the other side of one): the CPU parity tests' bounds
# (tests/test_torch_sgl_bf16.py), where the port's and JAX's bf16
# gradients sat up to 1.75e-2·max|g| (norm 1.08e-2) apart
BF16_STEP_LOSS_RTOL = 1e-2
BF16_STEP_GRAD_MAX = 3e-2
BF16_STEP_GRAD_NORM = 2e-2
# exported bf16 tables against the plain bf16 propagation: |Δ| within
# this share of the largest |entry| (the CPU tests' table bound)
BF16_TABLE_REL = 1e-2
# the InfoNCE pair against its plain version in float64, (B, n, d):
# SGL's users and items, NCL's centroids, the D = 128 instance; at the
# card tests' tau and bounds (tests/test_torch_nce.py: the f32 plain
# version reads up to ~1e-6 in lse and ~1.2e-6 in the gradients)
NCE_SHAPES = ((2048, 29859, 64), (2048, 40982, 64), (2048, 1000, 64),
              (2048, 29859, 128))
NCE_TAU = 0.2
NCE_LSE_ABS = 4e-6
NCE_GRAD_REL = 5e-6


def log(msg: str):
    print(msg, flush=True)


def lap_timer():
    """``lap(what)`` logs the wall time since the previous ``lap`` (or
    since this call) as ``time <what>: N s``: where a phase's time goes,
    read when a depth cut is chosen."""
    last = [time.perf_counter()]

    def lap(what: str):
        now = time.perf_counter()
        log(f"time {what}: {now - last[0]:.1f} s")
        last[0] = now
    return lap


class capped_train_steps:
    """Within the block, the train loaders ``data_preparation`` builds
    (general and sequential) yield at most ``steps`` batches per epoch
    and report that length: a depth cut that every count and check
    follows."""

    def __init__(self, steps: int):
        self.steps = steps

    def __enter__(self):
        import recbole_gnn_tpu_torch.quick_start as qs
        self.saved = {n: getattr(qs, n) for n in ("TrainLoader",
                                                  "SequentialTrainLoader")}
        for name, base in self.saved.items():
            setattr(qs, name, self._capped(base, self.steps))
        return self

    def __exit__(self, *exc):
        import recbole_gnn_tpu_torch.quick_start as qs
        for name, base in self.saved.items():
            setattr(qs, name, base)

    @staticmethod
    def _capped(base, steps):
        class Capped(base):
            def __len__(self):
                return min(steps, base.__len__(self))

            def __iter__(self):
                it = base.__iter__(self)
                for _ in range(len(self)):
                    yield next(it)
        Capped.__name__ = base.__name__
        return Capped


def counters():
    """Every kernel wrapper's launch counter, by kernel name (and K7b's
    calls, its composition of cuBLAS and ``torch.topk``)."""
    from recbole_gnn_tpu_torch.ops.ell_spmm import (ell_spmm,
                                                    ell_spmm_transpose)
    from recbole_gnn_tpu_torch.ops.gather import row_gather
    from recbole_gnn_tpu_torch.ops.nce import nce_lse, nce_lse_grad
    from recbole_gnn_tpu_torch.ops.segment_spmm import (
        segment_spmm, segment_spmm_transpose)
    from recbole_gnn_tpu_torch.ops.segment_sum import block_segment_sum
    from recbole_gnn_tpu_torch.parallel.topk import distributed_full_sort_topk
    return {"segment_spmm": segment_spmm,
            "segment_spmm_transpose": segment_spmm_transpose,
            "row_gather": row_gather, "block_segment_sum": block_segment_sum,
            "ell_spmm": ell_spmm, "ell_spmm_transpose": ell_spmm_transpose,
            "nce_lse": nce_lse, "nce_lse_grad": nce_lse_grad,
            "distributed_full_sort_topk": distributed_full_sort_topk}


def reset_counts():
    """Every launch counter and the program's span store to 0."""
    from recbole_gnn_tpu_torch.utils import trace
    for fn in counters().values():
        fn.launches = 0
    trace.reset()


def read_counts() -> dict:
    """Launches by kernel; K1 (K2) forward = segment_spmm's (ell_spmm's)
    count less the transpose's, which launches through it."""
    c = {k: fn.launches for k, fn in counters().items()}
    c["segment_spmm"] -= c["segment_spmm_transpose"]
    c["ell_spmm"] -= c["ell_spmm_transpose"]
    return c


def read_steps(path: str = "fit/epoch/step") -> dict:
    """The training steps at ``path`` since ``reset_counts`` (both
    buckets of the program's span store): ``steps``, those ``replayed``
    from a captured CUDA graph, the ``captures``, and ``issued``: the
    steps whose kernels went through the wrappers, so into the launch
    counters (the eager ones and each capture; a replay launches through
    no wrapper)."""
    from recbole_gnn_tpu_torch.utils import trace
    out = {"steps": 0, "replayed": 0, "captures": 0}
    for spans in trace.snapshot().values():
        if path in spans:
            for k in ("steps", "replayed"):
                out[k] += spans[path]["counters"].get(k, 0)
        if f"{path}/capture" in spans:
            out["captures"] += spans[f"{path}/capture"]["count"]
    out["issued"] = out["steps"] - out["replayed"] + out["captures"]
    return out


def fit_steps(tag: str, want_steps: int) -> dict:
    """``read_steps`` after a run that took ``want_steps`` training
    steps, checked and logged."""
    st = read_steps()
    log(f"[{tag}] training steps: {st['steps']}, {st['replayed']} of them "
        f"replayed from a CUDA graph ({st['captures']} captures); the "
        f"launch counters hold the kernels of {st['issued']} (the eager "
        "steps and the captures)")
    if st["steps"] != want_steps:
        raise AssertionError(f"[{tag}] {st['steps']} training steps, "
                             f"expected {want_steps}")
    return st


# -- device kernels per call ---------------------------------------------------

def device_kernels(fn) -> list[str]:
    """The device kernels a call of ``fn`` runs, by base name (no
    namespace, template or arguments), from ``torch.profiler`` over 20
    calls after one warm-up.  In a long process the profiler drops some
    records, at times all of a kernel's: a session that records fewer
    than 2 names is run again, up to 4 sessions in all."""
    cuda = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        names = set()
        for evt in prof.key_averages():
            if evt.device_type == cuda and evt.self_device_time_total:
                m = re.search(r"(\w+)(?:<[^>]*>)?\(", evt.key)
                names.add(m.group(1) if m else evt.key[:40])
        if len(names) >= 2:
            break
        log(f"profiler: session {attempt + 1} recorded {sorted(names)}; "
            "2 kernels expected")
    return sorted(names)


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


def check_kernels(name: str, graph, x: torch.Tensor, g: torch.Tensor,
                  share_sizes=(None,)) -> tuple[float, float]:
    """K1 (forward, on x) and K1ᵀ (transpose, on the cotangent g) against
    their plain versions on the same inputs: ``spmm_coo`` and the share
    schedule's ``segment_spmm_shares_plain``.  K1ᵀ is held against
    ``spmm_coo`` over the reverse arrays and, to check those arrays too,
    over the forward arrays with src and dst swapped.  K1 runs once per
    share size of ``share_sizes``: the public wrapper at the module's
    SHARE_EDGES (or None), the uncounted ``_segment_spmm_cuda`` at any
    other.  Returns (max |err| forward, max |err| transpose)."""
    from recbole_gnn_tpu_torch.ops.segment_spmm import (
        SHARE_EDGES, segment_spmm_shares_plain, segment_spmm_transpose,
        share_schedule, spmm_coo)
    errs = []
    fwd = (graph.src, graph.dst, graph.weight)
    rev = (graph.rev_src, graph.rev_dst, graph.rev_weight)
    swapped = (graph.dst, graph.src, graph.weight)
    runs = [("K1", t or SHARE_EDGES,
             k1_run(fwd, graph.rowptr, x, "f32x2", t),
             fwd, graph.rowptr, (fwd,), x, graph.n_nodes)
            for t in share_sizes]
    runs.append(("K1T", SHARE_EDGES,
                 segment_spmm_transpose(graph.rev_src, graph.rev_dst,
                                        graph.rev_weight, graph.rev_rowptr,
                                        g),
                 rev, graph.rev_rowptr, (rev, swapped), g,
                 graph.n_src_nodes))
    for kind, t, got, arrays, rp, plains, inp, n_out in runs:
        s, d, w = arrays
        abssum = spmm_coo(s, d, w.abs(), inp.abs(), n_out)
        max_err = max(hold(kind, name, got, spmm_coo(s, d, w, inp, n_out),
                           abssum) for s, d, w in plains)
        max_err = max(max_err, hold(
            f"{kind} (share schedule T={t})", name, got,
            segment_spmm_shares_plain(s, w, rp, inp, t), abssum))
        sch = share_schedule(rp, s.numel(), t)
        log(f"kernel check {kind} {name} T={t}: rows={n_out} "
            f"e_pad={graph.src.numel()} d={inp.shape[1]} "
            f"max_abs_err={max_err:.3e} "
            f"empty_rows={int((rp[1:] == rp[:-1]).sum())} "
            f"shares={sch.n_shares} split_rows={int(sch.split.sum())} "
            f"max_shares_per_row="
            f"{int((sch.last_share - sch.first_share).max()) + 1}")
        errs.append(max_err)
    return max(errs[:-1]), errs[-1]


def check_ell(name: str, graph, x: torch.Tensor, g: torch.Tensor
              ) -> tuple[float, float]:
    """K2 (forward over ``graph.ell``, on x) and K2ᵀ (over
    ``graph.rev_ell``, on the cotangent g) against their plain versions
    ``ell_spmm_plain`` (the JAX composition) and
    ``ell_spmm_pad_free_plain`` (each row's real slots only) and,
    through the graph's own COO arrays, against ``spmm_coo``; each rerun
    bit for bit.  Returns (max |err| forward, max |err| transpose)."""
    from recbole_gnn_tpu_torch.ops.ell_spmm import (
        ell_spmm, ell_spmm_plain, ell_spmm_pad_free_plain, ell_spmm_transpose)
    from recbole_gnn_tpu_torch.ops.segment_spmm import spmm_coo
    errs = []
    for kind, meta, inp, coo, n_out, run in (
            ("K2", graph.ell, x, (graph.src, graph.dst, graph.weight),
             graph.n_nodes, lambda: ell_spmm(graph.ell, x)),
            ("K2T", graph.rev_ell, g,
             (graph.rev_src, graph.rev_dst, graph.rev_weight),
             graph.n_src_nodes,
             lambda: ell_spmm_transpose(graph.rev_ell, g))):
        s, d, w = coo
        got = run()
        abssum = spmm_coo(s, d, w.abs(), inp.abs(), n_out)
        max_err = max(hold(kind, name, got, ell_spmm_plain(meta, inp),
                           abssum),
                      hold(f"{kind} (vs pad-free)", name, got,
                           ell_spmm_pad_free_plain(meta, inp), abssum),
                      hold(f"{kind} (vs spmm_coo)", name, got,
                           spmm_coo(s, d, w, inp, n_out), abssum))
        if not torch.equal(got, run()):
            raise AssertionError(f"{kind} reruns on {name} differ")
        log(f"kernel check {kind} {name}: rows={n_out} nnz={graph.nnz} "
            f"e_pad={meta.e_padded} ks={list(meta.ks)} "
            f"vrows={meta.n_vrows} split_nodes={meta.n_multi} "
            f"split_vrows={meta.n_multi_vrows} "
            f"isolated={meta.rest_node.numel() - meta.n_multi} "
            f"real_slots={int(meta.vlen.sum())} "
            f"d={inp.shape[1]} max_abs_err={max_err:.3e} rerun bit-equal")
        errs.append(max_err)
    return errs[0], errs[1]


def hold_nonfinite(kind: str, name: str, got: torch.Tensor,
                   want: torch.Tensor, abssum: torch.Tensor) -> float:
    """``got`` against ``want`` where some entries are not finite: the
    NaN and the inf positions equal, the finite entries within
    TOL_REL_ABSSUM · abssum.  Returns max |err| over the finite ones."""
    torch.cuda.synchronize()
    for what, f in (("NaN", torch.isnan), ("inf", torch.isinf)):
        if got.shape != want.shape or not torch.equal(f(got), f(want)):
            raise AssertionError(f"{kind} on {name}: its {what} positions "
                                 "differ from its plain version's")
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs()
    if not bool((err <= TOL_REL_ABSSUM * abssum[fin]).all()):
        raise AssertionError(f"{kind} disagrees with its plain version on "
                             f"{name}: max_abs_err {float(err.max()):.3e}")
    return float(err.max()) if err.numel() else 0.0


def check_ell_cases(rng: np.random.Generator, dev) -> tuple[float, float]:
    """K2 and K2ᵀ on three cases of their own.  ``above_half_l2``: an x
    of 210,000 × 64 rows (53.8 MB, above half the 50 MB L2, where its
    gathers miss the L2 more), by :func:`check_ell`.
    On a graph whose degrees sit on the bucket widths and K_CAP (rows
    with pad slots, split nodes, isolated nodes): ``nonfinite_x0``, inf
    and NaN in two columns of the input's row 0, which every pad slot
    multiplies by 0, so each padded row turns NaN there; and
    ``zero_weight_edge``, a real edge of weight 0 whose source row holds
    inf, which the pad-free version gathers all the same (pads are told
    by position, never by weight), so its row turns NaN.  Those two against both plain
    versions: NaN and inf positions equal, finite entries within the
    tolerance, reruns bit-equal.  Returns (max |err| forward, transpose)
    over the finite entries."""
    from recbole_gnn_tpu_torch.ops.ell_spmm import (
        ell_spmm, ell_spmm_plain, ell_spmm_pad_free_plain, ell_spmm_transpose)
    from recbole_gnn_tpu_torch.ops.segment_spmm import spmm_coo
    from recbole_gnn_tpu_torch.ops.spmm import build_graph
    n, e = 210_000, 2_000_000
    g = build_graph(rng.integers(0, n, e), (rng.zipf(1.3, e) - 1) % n,
                    rng.normal(size=e).astype(np.float32), n, n, device=dev,
                    impl="ell")
    x = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32)).to(dev)
    cot = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32)).to(dev)
    errs = list(check_ell("above_half_l2", g, x, cot))
    del g, x, cot

    n = 4000
    deg = rng.choice([0, 1, 3, 4, 7, 9, 60, 64, 200, 256, 300, 700], n,
                     p=[0.1, 0.15, 0.15, 0.1, 0.1, 0.1, 0.05, 0.1, 0.05,
                        0.04, 0.03, 0.03])
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n, len(dst))
    w = rng.normal(size=len(dst)).astype(np.float32)
    zero = int(np.flatnonzero(src != 0)[len(src) // 2])
    w[zero] = 0.0
    g = build_graph(src, dst, w, n, n, device=dev, impl="ell")
    for case in ("nonfinite_x0", "zero_weight_edge"):
        x = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32))
        cot = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32))
        if case == "nonfinite_x0":
            x[0, 3], x[0, 40] = float("inf"), float("nan")
            cot[0, 7], cot[0, 50] = float("-inf"), float("nan")
        else:           # its source row in K2, its destination in K2ᵀ
            x[src[zero], 11] = float("inf")
            cot[dst[zero], 21] = float("inf")
        x, cot = x.to(dev), cot.to(dev)
        for i, (kind, meta, inp, coo, n_out, run) in enumerate((
                ("K2", g.ell, x, (g.src, g.dst, g.weight), g.n_nodes,
                 lambda: ell_spmm(g.ell, x)),
                ("K2T", g.rev_ell, cot, (g.rev_src, g.rev_dst, g.rev_weight),
                 g.n_src_nodes, lambda: ell_spmm_transpose(g.rev_ell, cot)))):
            got = run()
            s, d, ww = coo
            abssum = spmm_coo(s, d, ww.abs(), inp.abs().nan_to_num(
                posinf=0.0), n_out)
            want = ell_spmm_plain(meta, inp)
            if not bool(torch.isnan(want).any()):
                raise AssertionError(f"{kind} {case}: no NaN to compare")
            err = max(hold_nonfinite(kind, case, got, want, abssum),
                      hold_nonfinite(f"{kind} (vs pad-free)", case, got,
                                     ell_spmm_pad_free_plain(meta, inp),
                                     abssum))
            again = run()
            if not torch.equal(got.nan_to_num(), again.nan_to_num()) or \
                    not torch.equal(torch.isnan(got), torch.isnan(again)):
                raise AssertionError(f"{kind} reruns on {case} differ")
            log(f"kernel check {kind} {case}: rows={n_out} nnz={g.nnz} "
                f"e_pad={meta.e_padded} real_slots={int(meta.vlen.sum())} "
                f"NaN entries={int(torch.isnan(got).sum())} inf entries="
                f"{int(torch.isinf(got).sum())} (as both plain versions) "
                f"max_abs_err (finite)={err:.3e} rerun bit-equal")
            errs[i] = max(errs[i], err)
    return errs[0], errs[1]


def check_nce(dev) -> dict:
    """The InfoNCE pair (``ops/nce.py``: ``nce_lse`` forward,
    ``nce_lse_grad`` back) against its plain version in float64 at each
    of NCE_SHAPES, on L2-normalised rows as ``info_nce`` passes them and
    a cotangent in [0, 1): lse within NCE_LSE_ABS, dv1 and dav2 within
    NCE_GRAD_REL of their largest entry (the f32 plain version's errors
    logged beside), one forward and one backward launch a call, a rerun
    bit for bit; and a forward call at the first shape runs exactly two
    device kernels.  Returns the worst errors."""
    from recbole_gnn_tpu_torch.models.init import l2_normalize
    from recbole_gnn_tpu_torch.ops.nce import nce_lse, nce_lse_plain

    def run(fn, q, k, g):
        q, k = (x.detach().requires_grad_(True) for x in (q, k))
        lse = fn(q, k, NCE_TAU)
        out = (lse.detach(), *torch.autograd.grad(lse, (q, k), g))
        torch.cuda.synchronize()
        return out

    def errs(got, ref):
        lse, dq, dk = (x.double() for x in got)
        return {"lse": float((lse - ref[0]).abs().max()),
                "dv1": float((dq - ref[1]).abs().max() / ref[1].abs().max()),
                "dav2": float((dk - ref[2]).abs().max()
                              / ref[2].abs().max())}

    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = {"lse": 0.0, "dv1": 0.0, "dav2": 0.0}
    for b, n, d in NCE_SHAPES:
        tag = f"NCE {b} x {n}, d {d}"
        q, k = (l2_normalize(torch.randn(r, d, device=dev, generator=gen))
                for r in (b, n))
        g = torch.rand(b, device=dev, generator=gen)
        reset_counts()
        got = run(nce_lse, q, k, g)
        launched = {k_: v for k_, v in read_counts().items() if v}
        if launched != {"nce_lse": 1, "nce_lse_grad": 1}:
            raise AssertionError(f"[{tag}] launched {launched}; expected "
                                 "one forward and one backward")
        ref = run(nce_lse_plain, q.double(), k.double(), g.double())
        kernel, plain = errs(got, ref), errs(
            run(nce_lse_plain, q, k, g), ref)
        log(f"[{tag}] against the float64 plain version: kernel "
            f"{json.dumps(kernel)}, f32 plain {json.dumps(plain)}")
        if not (kernel["lse"] < NCE_LSE_ABS and kernel["dv1"] < NCE_GRAD_REL
                and kernel["dav2"] < NCE_GRAD_REL):
            raise AssertionError(f"[{tag}] the kernel pair disagrees with "
                                 f"its plain version: {kernel}")
        for kind, x, y in zip(("lse", "dv1", "dav2"), got,
                              run(nce_lse, q, k, g)):
            if not torch.equal(x, y):
                raise AssertionError(f"[{tag}] a rerun's {kind} differs")
        worst = {kk: max(v, kernel[kk]) for kk, v in worst.items()}
        if (b, n, d) == NCE_SHAPES[0]:
            with torch.no_grad():
                names = device_kernels(lambda: nce_lse(q, k, NCE_TAU))
            log(f"[{tag}] device kernels per forward call: {names}")
            if len(names) != 2:
                raise AssertionError(f"the profiler saw {names} per "
                                     "nce_lse call; expected 2")
        del q, k, g, got, ref
    return worst


def k1_run(arrays, rp, inp, prec: str, t, transpose: bool = False):
    """K1 (or K1ᵀ, over the reverse CSR) in ``prec`` through its public
    wrapper at the module's SHARE_EDGES (``t`` None or that size), else
    through the uncounted ``_segment_spmm_cuda`` at share size ``t``."""
    from recbole_gnn_tpu_torch.ops.segment_spmm import (
        SHARE_EDGES, _segment_spmm_cuda, segment_spmm, segment_spmm_transpose)
    s, d, w = arrays
    if t in (None, SHARE_EDGES):
        fn = segment_spmm_transpose if transpose else segment_spmm
        return fn(s, d, w, rp, inp, prec)
    return _segment_spmm_cuda(s, d, w, rp, inp.contiguous(), t, prec)


def check_k1_modes(name: str, graph, x: torch.Tensor, g: torch.Tensor,
                   share_sizes=(None,)) -> dict:
    """K1 and K1ᵀ in each of ``K1_MODES`` against its plain version
    ``segment_spmm_plain`` (the same terms, summed in another order), at
    each share size of ``share_sizes`` (:func:`k1_run`).  Returns the
    largest |err| per mode."""
    from recbole_gnn_tpu_torch.ops.segment_spmm import (segment_spmm_plain,
                                                        spmm_coo)
    out = {}
    for prec in K1_MODES:
        errs = []
        for kind, arrays, rp, inp, n_out in (
                ("K1", (graph.src, graph.dst, graph.weight), graph.rowptr,
                 x, graph.n_nodes),
                ("K1T", (graph.rev_src, graph.rev_dst, graph.rev_weight),
                 graph.rev_rowptr, g, graph.n_src_nodes)):
            s, d, w = arrays
            # Σ|term|: bf16 rounding moves a term by < 0.4 %
            abssum = spmm_coo(s, d, w.abs(), inp.abs(), n_out)
            want = segment_spmm_plain(s, d, w, inp, n_out, prec)
            for t in share_sizes:
                got = k1_run(arrays, rp, inp, prec, t, kind == "K1T")
                errs.append(hold(f"{kind} {prec} T={t or 'SHARE_EDGES'}",
                                 name, got, want, abssum))
        out[prec] = max(errs)
    log(f"kernel check K1/K1T modes {name} T="
        + ",".join(str(t or "SHARE_EDGES") for t in share_sizes) + ": "
        + ", ".join(f"{p} max_abs_err={e:.3e}" for p, e in out.items()))
    return out


def check_d1(name: str, graph, x: torch.Tensor, share_sizes=(None,)
             ) -> float:
    """D1 on one graph's messages ``x[src]`` against its plain version
    and its share schedule (``block_segment_sum_shares_plain``): f32 with
    the edge weight, as the xla path calls it, also through a row
    pointer clamped to the middle third of the edges (``rowptr[0] !=
    0``); then, on the pre-weighted messages, unweighted f32, bf16 and
    hilo; each into a new output (empty rows 0) and into a given one
    (``out=``: out + Σ, empty rows left as they were); stream against
    its plain version.  At the module's SHARE_EDGES (None, the public
    wrapper) every case; at another share size of ``share_sizes`` (the
    uncounted ``_block_segment_sum_cuda``) the weighted ones.  Returns
    the largest |err|."""
    from recbole_gnn_tpu_torch.ops.gather import row_gather_plain
    from recbole_gnn_tpu_torch.ops.segment_sum import (
        SHARE_EDGES, block_segment_sum, block_segment_sum_plain,
        block_segment_sum_shares_plain)
    raw = row_gather_plain(x, graph.src)
    w, dst, rp = graph.weight, graph.dst, graph.rowptr
    msgs = raw * w[:, None]
    e = raw.shape[0]
    rp_mid = rp.clamp(e // 3 + 1, 2 * e // 3)
    prev = torch.randn(graph.n_nodes, x.shape[1], device=x.device)
    weighted = [("f32 weighted", raw, rp, "f32", w),
                ("f32 weighted rowptr[0]!=0", raw, rp_mid, "f32", w)]
    plain = [(m, msgs, rp, m, None) for m in ("f32", "bf16", "hilo")]
    max_err = 0.0
    for t in share_sizes:
        module_t = t in (None, SHARE_EDGES)
        t = t or SHARE_EDGES
        for label, m, rowptr, mode, wt in weighted + (plain if module_t
                                                       else []):
            def run(out=None):
                return d1_run(m, dst, rowptr, t, out, wt, mode)
            # Σ|term| (bf16 rounding moves |m| by < 0.4 %)
            abssum = block_segment_sum_plain(
                m.abs(), dst, rowptr, weight=None if wt is None else wt.abs())
            got = run()
            for kind, want in (
                    (f"D1 {label} T={t}", block_segment_sum_plain(
                        m, dst, rowptr, mode, weight=wt)),
                    (f"D1 {label} (share schedule T={t})",
                     block_segment_sum_shares_plain(m, rowptr, mode, weight=wt,
                                                    share_edges=t))):
                max_err = max(max_err, hold(kind, name, got, want, abssum))
            got = run(out=prev.clone())
            max_err = max(max_err, hold(
                f"D1 {label} out= T={t}", name, got, block_segment_sum_plain(
                    m, dst, rowptr, mode, out=prev.clone(), weight=wt),
                abssum + prev.abs()))
            empty = rowptr[1:] == rowptr[:-1]
            if not torch.equal(got[empty], prev[empty]):
                raise AssertionError(f"D1 {label} out= T={t} on {name} "
                                     "changed rows without edges")
    # stream mode: Σ|m| of the placeholder rows' own messages
    abssum = block_segment_sum_plain(msgs.abs(), dst, rp, "stream")
    for out in (None, prev):
        got = block_segment_sum(msgs, dst, rp, "stream",
                                out=None if out is None else out.clone())
        max_err = max(max_err, hold(
            "D1 stream" + (" out=" if out is not None else ""), name, got,
            block_segment_sum_plain(msgs, dst, rp, "stream",
                                    out=None if out is None else out.clone()),
            abssum + (0 if out is None else out.abs())))
    return max_err


def check_xla_kernels(name: str, graph, x: torch.Tensor, g: torch.Tensor,
                      chunk: int | None = None, share_sizes=(None,)) -> dict:
    """D2 and D1 against their plain versions on one graph: D2 gathers
    the forward messages (bit for bit); D1 as :func:`check_d1` says (not
    again when ``chunk`` is given); then the whole ``xla`` SpMM, forward
    over the graph and transpose over its reverse CSR (with ``chunk``,
    over forced edge chunks), against ``spmm_coo``.  Returns the largest
    |err| per kernel."""
    from recbole_gnn_tpu_torch.ops.gather import row_gather, row_gather_plain
    from recbole_gnn_tpu_torch.ops.segment_spmm import spmm_coo
    from recbole_gnn_tpu_torch.ops.spmm import xla_spmm
    d2 = hold("D2", name, row_gather(x, graph.src),
              row_gather_plain(x, graph.src), None)
    d1 = 0.0 if chunk else check_d1(name, graph, x, share_sizes)
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
    d1_log = "checked without chunks" if chunk else (
        "(f32 weighted and rowptr[0]!=0, f32/bf16/hilo/stream, new and "
        "out=, vs plain and share schedule T="
        + ",".join(str(t or "SHARE_EDGES") for t in share_sizes)
        + f") max_abs_err={d1:.3e}")
    log(f"kernel check D2/D1 {name}: rows={graph.n_nodes} "
        f"e_pad={graph.src.numel()} d={x.shape[1]} chunk={chunk} "
        f"D2 max_abs_err={d2:.3e} D1 {d1_log} xla SpMM fwd+T "
        f"max_abs_err={spmm_err:.3e}")
    return {"row_gather": d2, "block_segment_sum": d1, "xla_spmm": spmm_err}


def hold_bf16(kind: str, name: str, got: torch.Tensor, want: torch.Tensor,
              abssum: torch.Tensor | None) -> float:
    """A bf16-x kernel against its bf16-x plain version: the same dtype
    and shape, finite, and bit for bit without ``abssum``, else
    |kernel − plain| ≤ BF16_TOL_REL·|plain| + TOL_REL_ABSSUM·Σ|terms|
    elementwise (one bf16 unit where the two round apart, plus f32 sum
    order).  Returns max |err|."""
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{kind} on {name}: {got.dtype} "
                             f"{tuple(got.shape)} vs {want.dtype} "
                             f"{tuple(want.shape)}, or not finite")
    g, w = got.float(), want.float()
    err = (g - w).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if abssum is None:
        if not torch.equal(got, want):
            raise AssertionError(f"{kind} differs from its plain version on "
                                 f"{name} (max_abs_err {max_err:.3e})")
    elif not bool((err <= BF16_TOL_REL * w.abs()
                   + TOL_REL_ABSSUM * abssum).all()):
        raise AssertionError(
            f"{kind} disagrees with its plain version on {name}: "
            f"max_abs_err {max_err:.3e} exceeds {BF16_TOL_REL} x |plain| + "
            f"{TOL_REL_ABSSUM} x sum|term|")
    return max_err


def d1_run(msgs, dst, rowptr, t, out=None, weight=None, mode="f32"):
    """D1 through its public wrapper at the module's SHARE_EDGES (``t``
    None or that size), else through the uncounted
    ``_block_segment_sum_cuda`` at share size ``t``."""
    from recbole_gnn_tpu_torch.ops.segment_sum import (
        BM, EC, SHARE_EDGES, _block_segment_sum_cuda, block_segment_sum)
    if t in (None, SHARE_EDGES):
        return block_segment_sum(msgs, dst, rowptr, mode, out=out,
                                 weight=weight)
    return _block_segment_sum_cuda(msgs, dst, rowptr, mode, out, weight, BM,
                                   EC, t)


def check_bf16_kernels(name: str, pg, eg, x: torch.Tensor, g: torch.Tensor,
                       share_sizes=(None,)) -> dict:
    """Every kernel in its bf16-x mode against its bf16-x plain version
    on bf16 copies of x and of the cotangent g: K2 over ``eg.ell`` and
    K2ᵀ over ``eg.rev_ell`` (``ell_spmm_plain`` and the pad-free plain
    version, reruns bit-equal), K1 and K1ᵀ in each precision over
    ``pg``'s CSR (``segment_spmm_plain``, f32 out), D2 (bit for bit),
    D1 with the edge weight (new, ``out=``, a row pointer that does not
    start at 0 and one that holds only the row with the most edges,
    against its plain version and its share schedule) and the xla SpMM
    whole, forward and transpose.  K1, K1ᵀ and D1 run at each share
    size of ``share_sizes`` (:func:`k1_run`, :func:`d1_run`).  Returns
    the largest |err| by kernel (K1's and K1ᵀ's by precision)."""
    from recbole_gnn_tpu_torch.ops.ell_spmm import (
        ell_spmm, ell_spmm_pad_free_plain, ell_spmm_plain, ell_spmm_transpose)
    from recbole_gnn_tpu_torch.ops.gather import row_gather, row_gather_plain
    from recbole_gnn_tpu_torch.ops.segment_spmm import (
        PRECISIONS, segment_spmm_plain, spmm_coo)
    from recbole_gnn_tpu_torch.ops.segment_sum import (
        SHARE_EDGES as D1_T, block_segment_sum_plain,
        block_segment_sum_shares_plain)
    from recbole_gnn_tpu_torch.ops.spmm import xla_spmm
    bf = torch.bfloat16
    xb, gb = x.to(bf).contiguous(), g.to(bf).contiguous()

    def abssum(s, d, w, inp, n):
        return spmm_coo(s, d, w.abs(), inp.float().abs(), n)

    errs = {}
    for kind, key, meta, inp, coo, n_out, run in (
            ("K2 bf16x", "ell_spmm", eg.ell, xb,
             (eg.src, eg.dst, eg.weight), eg.n_nodes,
             lambda: ell_spmm(eg.ell, xb)),
            ("K2T bf16x", "ell_spmm_transpose", eg.rev_ell, gb,
             (eg.rev_src, eg.rev_dst, eg.rev_weight), eg.n_src_nodes,
             lambda: ell_spmm_transpose(eg.rev_ell, gb))):
        got = run()
        a = abssum(*coo, inp, n_out)
        errs[key] = max(
            hold_bf16(kind, name, got, ell_spmm_plain(meta, inp), a),
            hold_bf16(f"{kind} (vs pad-free)", name, got,
                      ell_spmm_pad_free_plain(meta, inp), a))
        if not torch.equal(got, run()):
            raise AssertionError(f"{kind} reruns on {name} differ")
    fwd = (pg.src, pg.dst, pg.weight, pg.rowptr, pg.n_nodes)
    rev = (pg.rev_src, pg.rev_dst, pg.rev_weight, pg.rev_rowptr,
           pg.n_src_nodes)
    errs["segment_spmm"], errs["segment_spmm_transpose"] = {}, {}
    for p in PRECISIONS:
        for kind, (s, d, w, rp, n_out), inp in (("K1", fwd, xb),
                                                ("K1T", rev, gb)):
            want = segment_spmm_plain(s, d, w, inp, n_out, p)
            a = abssum(s, d, w, inp, n_out)
            for t in share_sizes:
                e = hold_bf16(f"{kind} bf16x {p} T={t or 'SHARE_EDGES'}",
                              name, k1_run((s, d, w), rp, inp, p, t,
                                           kind == "K1T"), want, a)
                by_p = errs["segment_spmm" if kind == "K1"
                            else "segment_spmm_transpose"]
                by_p[p] = max(by_p.get(p, 0.0), e)
    raw = row_gather(xb, pg.src)
    errs["row_gather"] = hold_bf16("D2 bf16x", name, raw,
                                   row_gather_plain(xb, pg.src), None)
    w, dst, rp = pg.weight, pg.dst, pg.rowptr
    e = raw.shape[0]
    prev = torch.randn(pg.n_nodes, x.shape[1], device=x.device).to(bf)
    hub = int(torch.argmax(rp[1:] - rp[:-1]))
    d1 = 0.0
    for t in share_sizes:
        tt = t or D1_T
        for label, rowptr in (
                ("", rp), (" rowptr[0]!=0", rp.clamp(e // 3 + 1, 2 * e // 3)),
                (" hub row", rp.clamp(rp[hub], rp[hub + 1]))):
            label = f"{label} T={t or 'SHARE_EDGES'}"
            a = block_segment_sum_plain(raw.float().abs(), dst, rowptr,
                                        weight=w.abs())
            got = d1_run(raw, dst, rowptr, t, weight=w)
            for kind, want in (
                    (f"D1 bf16x weighted{label}", block_segment_sum_plain(
                        raw, dst, rowptr, "f32", weight=w)),
                    (f"D1 bf16x weighted{label} (share schedule)",
                     block_segment_sum_shares_plain(
                         raw, rowptr, "f32", weight=w, share_edges=tt))):
                d1 = max(d1, hold_bf16(kind, name, got, want, a))
            if not torch.equal(got, d1_run(raw, dst, rowptr, t, weight=w)):
                raise AssertionError(f"D1 bf16x{label} reruns on {name} "
                                     "differ")
            got = d1_run(raw, dst, rowptr, t, out=prev.clone(), weight=w)
            d1 = max(d1, hold_bf16(
                f"D1 bf16x weighted out={label}", name, got,
                block_segment_sum_plain(raw, dst, rowptr, "f32",
                                        out=prev.clone(), weight=w),
                a + prev.float().abs()))
            empty = rowptr[1:] == rowptr[:-1]
            if not torch.equal(got[empty], prev[empty]):
                raise AssertionError(f"D1 bf16x out={label} on {name} "
                                     "changed rows without edges")
    errs["block_segment_sum"] = d1
    xla = 0.0
    for kind, (s, d, w, rp, n_out), inp in (("xla bf16x", fwd, xb),
                                            ("xla T bf16x", rev, gb)):
        xla = max(xla, hold_bf16(
            kind, name, xla_spmm(s, d, w, rp, inp),
            block_segment_sum_plain(row_gather_plain(inp, s), d, rp, "f32",
                                    weight=w),
            abssum(s, d, w, inp, n_out)))
    errs["xla_spmm"] = xla
    log(f"kernel check bf16x {name}: d={x.shape[1]} T="
        + ",".join(str(t or "SHARE_EDGES") for t in share_sizes) + " "
        + ", ".join(
            f"{k} max_abs_err=" + (json.dumps({p: f"{v:.3e}"
                                               for p, v in e.items()})
                                   if isinstance(e, dict) else f"{e:.3e}")
            for k, e in errs.items()))
    return errs


def merge_errs(into: dict, errs: dict) -> dict:
    """The larger |err| per key (per precision for K1 and K1ᵀ)."""
    for k, v in errs.items():
        if isinstance(v, dict):
            merge_errs(into.setdefault(k, {}), v)
        else:
            into[k] = max(into.get(k, 0.0), v)
    return into


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
    n, e = 50_000, 2_000_000                        # one row, 60 % of edges
    giant = rng.integers(0, n, e)
    giant[:e * 3 // 5] = n // 3
    cases.append(("giant_row", rng.integers(0, n, e), giant, n, n, 64))
    # every degree a multiple of 64, a fifth of the rows empty: rows end
    # exactly on share boundaries and empty rows sit on them
    n = 6000
    deg = 64 * rng.choice([0, 1, 2, 4, 8], n, p=[0.2, 0.3, 0.2, 0.2, 0.1])
    on_bounds = np.repeat(np.arange(n), deg)
    cases.append(("share_boundaries", rng.integers(0, n, len(on_bounds)),
                  on_bounds, n, n, 64))
    e = 30_000                                      # one destination row
    cases.append(("single_row", rng.integers(0, 100, e), np.zeros(e, int),
                  1, 100, 64))
    # degrees on and next to the ELL bucket widths and K_CAP (256: one
    # virtual row; 257 and 513: split), a tenth of the nodes isolated
    n = 4000
    deg = rng.choice([0, 1, 2, 4, 7, 8, 9, 64, 255, 256, 257, 512, 513], n,
                     p=[0.1, 0.15, 0.15, 0.1, 0.05, 0.1, 0.05, 0.1, 0.04,
                        0.06, 0.04, 0.03, 0.03])
    on_buckets = np.repeat(np.arange(n), deg)
    cases.append(("ell_boundaries", rng.integers(0, n, len(on_buckets)),
                  on_buckets, n, n, 64))
    # 72-byte bf16 rows: D1 stages bf16 messages by cp.async, not TMA
    n, e = 3000, 30000
    cases.append(("d36", rng.integers(0, n, e), rng.integers(0, n, e), n, n,
                  36))
    return [(nm, s, d_, rng.normal(size=len(s)).astype(np.float32), nd, ns,
             dim) for nm, s, d_, nd, ns, dim in cases]


def boundary_rows(rowptr: torch.Tensor, t: int) -> tuple[int, int]:
    """(non-empty rows that end on a multiple of t, empty rows that sit
    on one) — what the share_boundaries case must hold."""
    b0, b1 = rowptr[:-1], rowptr[1:]
    ends = int(((b1 > b0) & (b1 % t == 0)).sum())
    empties = int(((b1 == b0) & (b0 % t == 0)).sum())
    return ends, empties


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


def http_roundtrip(srv, users: list, k: int, key: str = "users") -> dict:
    """One POST /recommend of ``users`` (or, with ``key="sessions"``,
    of item-token sessions) to a threading HTTP server on ``srv``."""
    from recbole_gnn_tpu_torch.serve import make_http_server
    httpd = make_http_server(srv, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        body = json.dumps({key: users, "k": k}).encode()
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

def train_config(tmp: str, impl: str, model: str = "LightGCN") -> dict:
    """The model at LightGCN's published width on the sparse graph, one
    epoch of the default 2,048-pair batches, then validation; each (model, impl) checkpoints into its own
    directory."""
    ck = os.path.join(tmp, f"{model}-{impl}")
    return {"data_path": tmp, "checkpoint_dir": ck,
            "embedding_size": EMBEDDING_SIZE, "n_layers": N_LAYERS,
            "enable_sparse": True, "sparse_spmm_impl": impl,
            "epochs": 1, "eval_step": 1,
            "seed": SEED, "state": "ERROR", "save_dataset": True,
            "metrics_log_path": os.path.join(ck, "train.jsonl")}


def expected_train_counts(impl: str, steps: int, n_evals: int,
                          model: str = "LightGCN") -> dict:
    """Per step (of those whose kernels went through the wrappers:
    ``read_steps``'s ``issued``) the model's propagations, each N_LAYERS
    SpMMs forward and N_LAYERS transpose SpMMs back, and N_LAYERS forward
    per evaluation.
    ell: K2 forward, K2ᵀ back; pallas: K1 forward, K1ᵀ back; xla: D2
    and D1 once per layer in each forward and each backward."""
    prop = N_LAYERS * PROPAGATIONS[model] * steps
    fwd, bwd = prop + N_LAYERS * n_evals, prop
    want = {k: 0 for k in counters()}
    if impl == "pallas":
        want.update(segment_spmm=fwd, segment_spmm_transpose=bwd)
    elif impl == "ell":
        want.update(ell_spmm=fwd, ell_spmm_transpose=bwd)
    else:
        want.update(row_gather=fwd + bwd, block_segment_sum=fwd + bwd)
    return want


def check_metrics(name: str, result: dict):
    if not result or not all(math.isfinite(v) for v in result.values()):
        raise AssertionError(f"{name} metrics missing or not finite: {result}")


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

    want = {"pallas": {"segment_spmm": N_LAYERS,
                       "segment_spmm_transpose": N_LAYERS},
            "ell": {"ell_spmm": N_LAYERS, "ell_spmm_transpose": N_LAYERS},
            "xla": {"row_gather": 2 * N_LAYERS,
                    "block_segment_sum": 2 * N_LAYERS}}[impl]
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


def train_path(tmp: str, impl: str, dev, model_name: str = "LightGCN"
               ) -> dict:
    """Train through ``run_recbole_gnn_tpu`` with every counter set to 0
    just before and read just after; check the run and a re-evaluation
    of its checkpoint; for LightGCN, one step against the plain
    version."""
    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    from recbole_gnn_tpu_torch.models import get_model
    from recbole_gnn_tpu_torch.quick_start import (create_dataset,
                                                   data_preparation,
                                                   run_recbole_gnn_tpu)
    from recbole_gnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                       params_from_numpy)
    from recbole_gnn_tpu_torch.train.trainer import Trainer
    cd = train_config(tmp, impl, model_name)
    epochs = cd["epochs"]
    tag = impl if model_name == "LightGCN" else f"{model_name} {impl}"
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = run_recbole_gnn_tpu(model=model_name, dataset="gowalla_shape",
                              config_dict=cd, saved=True, verbose=False)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    with open(cd["metrics_log_path"]) as f:
        events = [json.loads(line) for line in f]

    config = Config(model=model_name, dataset="gowalla_shape",
                    config_dict=cd)
    (train_loader, train_ds), (valid_loader, _), _ = data_preparation(
        config, create_dataset(config))
    model = get_model(model_name)(config, train_ds, dev)
    graph = model.consts["graph"]
    steps = len(train_loader)
    epoch_events = [e for e in events if e["event"] == "train_epoch"]
    valids = [e for e in events if e["event"] == "valid"]
    losses = [e["loss"] for e in epoch_events]
    log(f"[{tag}] train: {graph.n_nodes} nodes, {graph.nnz} edges (e_pad "
        f"{graph.n_edges_padded}); {steps} steps per epoch of "
        f"{train_loader.batch_size} pairs; {epochs} epochs in "
        f"{wall:.1f} s end to end")
    for e in epoch_events:
        log(f"[{tag}] train epoch {e['epoch']}: loss {e['loss']:.6f}, "
            f"{e['seconds']:.3f} s, {e['examples_per_s']:.0f} examples/s")
    for e in valids:
        log(f"[{tag}] valid epoch {e['epoch']}: {e['seconds']:.3f} s, "
            f"recall@10 {e['recall@10']:.5f}, ndcg@10 {e['ndcg@10']:.5f}")
    log(f"[{tag}] test: {res['test_result']}")
    if len(losses) != epochs or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[{tag}] training losses: {losses}")
    for e in valids:
        check_metrics(f"[{tag}] valid epoch {e['epoch']}",
                      {k: v for k, v in e.items() if "@" in k})
    check_metrics(f"[{tag}] test", res["test_result"])
    if not res["test_result"]["recall@10"] > 0:
        raise AssertionError(f"[{tag}] test recall@10 is 0")
    n_evals = len(valids) + 1
    issued = fit_steps(tag, epochs * steps)["issued"]
    want = expected_train_counts(impl, issued, n_evals, model_name)
    log(f"[{tag}] train launches: {counts} (expected {want}: "
        f"{N_LAYERS} layers x ({PROPAGATIONS[model_name]} propagations x "
        f"{issued} steps forward and back + {n_evals} evaluations "
        "forward))")
    if counts != want:
        raise AssertionError(f"[{tag}] training launch counts differ")
    log(f"[{tag}] train peak device memory (max_memory_allocated): "
        f"{peak_bytes} bytes ({peak_bytes / 2**30:.3f} GiB)")

    ckpt = os.path.join(cd["checkpoint_dir"],
                        f"{model_name}-gowalla_shape.ckpt")
    state = load_checkpoint(ckpt)
    # the loss's fall over the epoch: one fixed batch's loss from the
    # params fit() started with and from the trained checkpoint (the
    # same draws for both)
    fixed = to_device(next(iter(train_loader)), dev)
    with torch.no_grad():
        fixed_loss = [float(model.calculate_loss(
            p, model.consts, {}, fixed,
            torch.Generator().manual_seed(SEED))[0])
            for p in (model.init_params(torch.Generator().manual_seed(SEED)),
                      params_from_numpy(state["params"], dev))]
    log(f"[{tag}] loss of the first training batch: {fixed_loss[0]:.6f} "
        f"from the initial params, {fixed_loss[1]:.6f} after the epoch")
    if not (all(map(math.isfinite, fixed_loss))
            and fixed_loss[1] < fixed_loss[0]):
        raise AssertionError(f"[{tag}] the loss did not fall: {fixed_loss}")
    trainer = Trainer(config, model)
    params = params_from_numpy(state["params"], dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = trainer.evaluator.evaluate(params, {}, valid_loader)
    eval_s = time.perf_counter() - t0
    log(f"[{tag}] full-sort evaluation of {len(valid_loader.eval_users)} "
        f"valid users x {model.n_items} items (host clock): {eval_s:.3f} s")
    # the checkpoint holds the best epoch's params: re-evaluating them
    # gives that epoch's validation result
    best = next(e for e in valids if e["epoch"] == int(state["best_epoch"]))
    for k, v in result.items():
        if not abs(v - best[k]) <= 1e-6:
            raise AssertionError(
                f"[{tag}] re-evaluation of the checkpoint: {k} {v} "
                f"differs from its epoch's validation {best[k]}")
    if model_name == "LightGCN":
        batch = to_device(next(iter(train_loader)), dev)
        step_err = step_vs_plain(model, params, batch, impl)
        log(f"[{tag}] step vs plain: " + ", ".join(
            f"{k} {v:.6e}" for k, v in step_err.items()))
    return {"config": config, "ckpt": ckpt, "model": model, "graph": graph,
            "params": params, "counts": counts}


def serve_path(run: dict, tmp: str, impl: str, dev,
               batches=BATCHES, label: str | None = None) -> dict:
    """Export the trained checkpoint and serve it, every counter set to
    0 just before and read just after; the export must launch the
    impl's forward kernels once per layer, serving none.  The exported
    tables are held against a plain propagation: the mean of layers
    0..N_LAYERS over the graph (LightGCN's and SGL's evaluation); for an
    ``activation_dtype: bfloat16`` run (``label``), from bf16 on the
    plain versions of the ell kernel, within BF16_TABLE_REL of the
    largest |entry| (a layer's bf16 rounding may differ by one unit where
    the f32 sum order moves it, and the next layers carry it)."""
    from recbole_gnn_tpu_torch.ops.ell_spmm import ell_spmm_plain
    from recbole_gnn_tpu_torch.ops.segment_spmm import spmm_coo
    from recbole_gnn_tpu_torch.serve import RecServer, export_artifact
    model_name = str(run["config"]["model"])
    name = label or model_name
    art = os.path.join(tmp, f"{name.lower()}-{impl}.npz")
    tag = impl if model_name == "LightGCN" else f"{name} {impl}"
    bf16 = str(run["config"].or_default("activation_dtype", "")
               ).startswith("bf")
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
    log(f"[{tag}] export: {export_s:.2f} s, launches {export_counts}")
    log(f"[{tag}] recommend latency (ms, median of 5, k=10): "
        + ", ".join(f"B={b}: {ms:.2f}" for b, ms in latency.items()))
    log(f"[{tag}] http: {len(out['items'])} users answered")
    fwd = {"pallas": ("segment_spmm",), "ell": ("ell_spmm",),
           "xla": ("row_gather", "block_segment_sum")}[impl]
    want = {k: (N_LAYERS if k in fwd else 0) for k in counts}
    if export_counts != want or counts != want:
        raise AssertionError(
            f"[{tag}] serving launched {export_counts} in the export and "
            f"{counts} on the whole path; expected {want} for both")

    # the exported (trained) tables against a plain propagation
    graph, params = run["graph"], run["params"]
    with torch.inference_mode():
        h = torch.cat([params["user_emb"], params["item_emb"]])
        if bf16:
            h = h.to(torch.bfloat16)
        layers = [h]
        for _ in range(N_LAYERS):
            h = (ell_spmm_plain(graph.ell, h) if bf16 else
                 spmm_coo(graph.src, graph.dst, graph.weight, h,
                          graph.n_nodes))
            layers.append(h)
        final = torch.stack([t.float() for t in layers]).mean(0).cpu().numpy()
    with np.load(art, allow_pickle=False) as z:
        exported = np.concatenate([z["user_table"], z["item_table"]])
    table_err = float(np.abs(exported - final).max())
    log(f"[{tag}] export vs plain propagation: max_abs_err="
        f"{table_err:.3e} (max |table| {np.abs(final).max():.3e})")
    if bf16:
        if not table_err <= BF16_TABLE_REL * float(np.abs(final).max()):
            raise AssertionError(f"[{tag}] exported tables differ from the "
                                 f"plain bf16 propagation by {table_err:.3e}")
    else:
        np.testing.assert_allclose(exported, final, rtol=1e-4, atol=1e-7)
    return counts


# -- the general family ------------------------------------------------------

GENERAL_MODELS = ("SGL", "NGCF", "NCL", "HMLET", "LightGCL", "DirectAU",
                  "NeuMF", "SSL4REC")
# the deliberate departures from each model's published yaml, each with
# its reason (logged with the run)
GENERAL_OVERRIDES = {
    "NCL": ({"warm_up_step": 0},
            "ProtoNCE is left out for the first warm_up_step (20) epochs; "
            "at 0 it is on the path"),
    "HMLET": ({"warm_up_epochs": 0},
              "the gates are frozen and the temperature held for the first "
              "warm_up_epochs (50); at 0 epoch 1 trains the gates and "
              "decays the temperature"),
    "DirectAU": ({"encoder": "LightGCN"},
                 "the MF encoder runs no graph (its parity is checked on the "
                 "CPU); the LightGCN encoder puts its SpMMs on the path"),
}
# HMLET: epoch 0 frozen gates (mode 0), epoch 1 trained ones (mode 1)
GENERAL_EPOCHS = {"HMLET": 2}
# K2 launches per training step (as many K2T) and per evaluation, at
# each model's published depth: SGL 3 propagations x 3 layers; NGCF 3
# BiGNN layers; NCL max(3, 2 x 1) layers; HMLET 4 layers + 2 gated
# non-linear branches; LightGCL 2 layers x 2 rectangular graphs;
# DirectAU's LightGCN encoder 3 layers; NeuMF and SSL4REC no graph
GENERAL_STEP_SPMMS = {"SGL": 9, "NGCF": 3, "NCL": 3, "HMLET": 6,
                      "LightGCL": 4, "DirectAU": 3, "NeuMF": 0, "SSL4REC": 0}
GENERAL_EVAL_SPMMS = {"SGL": 3, "NGCF": 3, "NCL": 3, "HMLET": 6,
                      "LightGCL": 4, "DirectAU": 3, "NeuMF": 0, "SSL4REC": 0}
# calls of the InfoNCE pair per training step (nce_lse forward, as many
# nce_lse_grad): SGL's users and items; NCL's two layer terms and, with
# warm_up_step 0 (GENERAL_OVERRIDES), its two ProtoNCE terms
GENERAL_STEP_NCES = {"SGL": 2, "NCL": 4}


def nce_counts(model_name: str, steps: int = 1) -> dict:
    """The InfoNCE pair's launches in ``steps`` of ``model_name``'s
    training steps, by counter (none for a model without the pair)."""
    n = GENERAL_STEP_NCES.get(model_name, 0) * steps
    return {"nce_lse": n, "nce_lse_grad": n} if n else {}


# SGL with bf16 activations: its run on ell (as the general models'),
# then SGL_BF16_STEPS steps on each of these graphs, each held against
# its plain step; the dense block of the Gowalla shape (29,858 × 40,981
# = 1.22e9 entries) needs dense_graph_max_entries above the default 3e8
SGL_BF16 = {"activation_dtype": "bfloat16"}
SGL_BF16_STEPS = 2
SGL_BF16_GRAPHS = (
    ("pallas", {"sparse_spmm_impl": "pallas",
                "pallas_spmm_precision": "f32x2"},
     {"segment_spmm": 9, "segment_spmm_transpose": 9, **nce_counts("SGL")}),
    ("xla", {"sparse_spmm_impl": "xla"},
     {"row_gather": 18, "block_segment_sum": 18, **nce_counts("SGL")}),
    ("dense", {"enable_sparse": False,
               "dense_graph_max_entries": 1_300_000_000}, nce_counts("SGL")))
SGL_BF16_METRIC_BAND = 0.02     # the JAX package's own band against f32


def general_config(tmp: str, model: str, impl: str = "ell", **over) -> dict:
    """The model at its published yaml settings on the sparse graph,
    with its GENERAL_OVERRIDES and ``over``; each (model, impl) in its
    own checkpoint directory."""
    ck = os.path.join(tmp, f"{model}-{impl}")
    cd = {"data_path": tmp, "checkpoint_dir": ck, "enable_sparse": True,
          "sparse_spmm_impl": impl, "epochs": GENERAL_EPOCHS.get(model, 1),
          "eval_step": 1, "seed": SEED, "state": "ERROR",
          "save_dataset": True,
          "metrics_log_path": os.path.join(ck, "train.jsonl")}
    cd.update(GENERAL_OVERRIDES.get(model, ({}, ""))[0])
    cd.update(over)
    return cd


def general_step_vs_plain(model, params: dict, extras: dict, batch: dict,
                          mode: int, want: dict, tag: str,
                          bf16: bool = False) -> dict:
    """One training step of ``model`` on the kernels against the same
    step with every sparse SpMM replaced by the plain ``spmm_coo`` over
    the same graph and weights (the views', the dropped edges') and the
    InfoNCE's logsumexp by its plain version (``nce_lse_plain``: cuBLAS
    f32 and ``torch.logsumexp``), differentiated by autograd; same
    params, extras, batch and draws (a card generator seeded alike for
    both).  The kernel step must launch ``want``, the plain step
    nothing.  Gradients of every param leaf:
    |Δ| ≤ STEP_RTOL·|g| + GENERAL_STEP_ATOL_FRAC·max|g| with max|g| over
    all leaves (a gate's bias before its BatchNorm has a true gradient
    of 0, so its own maximum is rounding noise); the loss: STEP_RTOL.
    With ``bf16`` (``activation_dtype: bfloat16``) the plain step runs
    the plain versions of the graph impl's own kernels, with their bf16
    rounding (:class:`PlainSpmm`), held by :func:`hold_step`'s bf16
    bounds."""
    import importlib
    from recbole_gnn_tpu_torch.ops import nce
    from recbole_gnn_tpu_torch.ops.segment_spmm import spmm_coo
    # by module path: the ops package re-exports a function named spmm
    spmm_mod = importlib.import_module("recbole_gnn_tpu_torch.ops.spmm")
    # the modules that bind spmm by name: LightGCL's and SEPT's
    bound = [importlib.import_module(f"recbole_gnn_tpu_torch.models.{m}")
             for m in ("general.lightgcl", "social.sept")]

    reset_counts()
    k_loss, k_grads = step_loss_and_grads(model, params, extras, batch, mode)
    got = {k: v for k, v in read_counts().items() if v}
    if got != want:
        raise AssertionError(f"[{tag}] the kernel step launched {got}, "
                             f"expected {want}")

    def plain(graph, x, weight_grad=False):
        if bf16:
            return PlainSpmm.apply(x, graph)
        return spmm_coo(graph.src, graph.dst, graph.weight, x, graph.n_nodes)

    kernel_spmm, kernel_nce = spmm_mod.spmm, nce.nce_lse
    for m in [spmm_mod] + bound:
        m.spmm = plain
    nce.nce_lse = nce.nce_lse_plain   # what models/losses.py calls
    try:
        reset_counts()
        p_loss, p_grads = step_loss_and_grads(model, params, extras, batch,
                                              mode)
        if any(read_counts().values()):
            raise AssertionError(f"[{tag}] the plain step launched a kernel: "
                                 f"{read_counts()}")
    finally:
        for m in [spmm_mod] + bound:
            m.spmm = kernel_spmm
        nce.nce_lse = kernel_nce
    return hold_step(tag, "plain", (k_loss, k_grads), (p_loss, p_grads),
                     bf16)


def plain_spmm(graph, x: torch.Tensor, transpose: bool) -> torch.Tensor:
    """The graph impl's SpMM (or its transpose) by the plain versions of
    its kernels, with their rounding for a bf16 x: ``ell_spmm_plain``
    over the layouts; ``segment_spmm_plain`` in the graph's precision
    (``pallas``, f32 out); D2's and D1's plain versions (``xla``)."""
    from recbole_gnn_tpu_torch.ops.ell_spmm import ell_spmm_plain
    from recbole_gnn_tpu_torch.ops.gather import row_gather_plain
    from recbole_gnn_tpu_torch.ops.segment_spmm import (reverse_weight,
                                                        segment_spmm_plain)
    from recbole_gnn_tpu_torch.ops.segment_sum import block_segment_sum_plain
    if graph.impl == "ell" and graph.ell is not None and \
            graph.rev_ell is not None:
        return ell_spmm_plain(graph.rev_ell if transpose else graph.ell, x)
    if transpose:
        s, d, w = graph.rev_src, graph.rev_dst, reverse_weight(graph,
                                                               graph.weight)
        rp, n = graph.rev_rowptr, graph.n_src_nodes
    else:
        s, d, w, rp, n = (graph.src, graph.dst, graph.weight, graph.rowptr,
                          graph.n_nodes)
    if graph.impl == "pallas":
        return segment_spmm_plain(s, d, w, x, n, graph.precision)
    return block_segment_sum_plain(row_gather_plain(x, s), d, rp, "f32",
                                   weight=w)


class PlainSpmm(torch.autograd.Function):
    """``spmm`` on the plain versions (:func:`plain_spmm`), forward and
    transpose: the plain step of an ``activation_dtype: bfloat16`` run
    (autograd hands the transpose's output on in x's dtype, as it does
    the kernels')."""

    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph = graph
        return plain_spmm(graph, x, False)

    @staticmethod
    def backward(ctx, g):
        return plain_spmm(ctx.graph, g.contiguous(), True), None


def step_loss_and_grads(model, params: dict, extras: dict, batch: dict,
                        mode: int):
    """One training step's loss and the gradient of every param leaf
    (0 for a leaf the loss does not use), from fresh copies of
    ``params``; the model's draws from a card generator seeded with
    SEED, so every call draws alike."""
    from recbole_gnn_tpu_torch.train.optim import tree_leaves, tree_map
    p = tree_map(lambda v: v.detach().clone().requires_grad_(True), params)
    gen = torch.Generator(device=batch["user_id"].device).manual_seed(SEED)
    loss, _ = model.calculate_loss(p, model.consts, extras, batch, gen,
                                   mode=mode)
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(leaves, grads)]
    torch.cuda.synchronize()
    return loss.detach(), grads


def hold_step(tag: str, what: str, got: tuple, want: tuple,
              bf16: bool = False) -> dict:
    """A step's (loss, grads) against another form of the same step
    (``what``): the loss within STEP_RTOL, every gradient leaf within
    |Δ| ≤ STEP_RTOL·|g| + GENERAL_STEP_ATOL_FRAC·max|g|, max|g| over all
    leaves (a gate's bias before its BatchNorm has a true gradient of 0,
    so its own maximum is rounding noise).  With ``bf16`` (an
    ``activation_dtype: bfloat16`` step, whose outputs and cotangents are
    rounded to bf16 where f32 sum order may put them on the other side):
    the loss within BF16_STEP_LOSS_RTOL, each leaf's largest |Δ| within
    BF16_STEP_GRAD_MAX·max|g| and ‖Δ‖ within BF16_STEP_GRAD_NORM·‖g‖."""
    (k_loss, k_grads), (p_loss, p_grads) = got, want
    out = {"loss_kernel": float(k_loss), f"loss_{what}": float(p_loss),
           "loss_abs_err": float((k_loss - p_loss).abs())}
    rtol = BF16_STEP_LOSS_RTOL if bf16 else STEP_RTOL
    if not out["loss_abs_err"] <= rtol * abs(float(p_loss)):
        raise AssertionError(f"[{tag}] kernel step loss differs from "
                             f"{what}: {out}")
    g_max = max(float(g.abs().max()) for g in p_grads if g.numel())
    worst = worst_norm = 0.0
    for i, (kg, pg) in enumerate(zip(k_grads, p_grads)):
        err = (kg - pg).abs()
        if bf16:
            norm = float(err.norm() / pg.norm().clamp_min(1e-30))
            worst_norm = max(worst_norm, norm)
            ok = (float(err.max()) <= BF16_STEP_GRAD_MAX * g_max
                  and norm <= BF16_STEP_GRAD_NORM)
            lim = BF16_STEP_GRAD_MAX * g_max
        else:
            lim = STEP_RTOL * pg.abs() + GENERAL_STEP_ATOL_FRAC * g_max
            ok = bool((err <= lim).all())
        if not (ok and bool(torch.isfinite(kg).all())):
            raise AssertionError(
                f"[{tag}] kernel step gradient of leaf {i} differs from "
                f"{what}: max |err| {float(err.max()):.3e}, worst excess "
                f"{float((err - lim).max()):.3e}")
        worst = max(worst, float(err.max()))
    out.update(grad_max_abs_err=worst, grad_max_abs=g_max,
               grad_leaves=len(p_grads))
    if bf16:
        out["grad_max_rel_norm_err"] = worst_norm
    return out


def general_path(tmp: str, model_name: str, dev, over: dict | None = None,
                 label: str | None = None) -> dict:
    """Train ``model_name`` through ``run_recbole_gnn_tpu`` on ``ell``
    with every counter set to 0 just before and read just after; check
    the run, its launch counts and a re-evaluation of its checkpoint;
    for a graph model one step on the kernels against the plain one.
    ``over``: config overrides, the run named ``label`` (its own
    checkpoint directory); ``activation_dtype: bfloat16`` holds the step
    by :func:`hold_step`'s bf16 bounds."""
    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    from recbole_gnn_tpu_torch.models import get_model
    from recbole_gnn_tpu_torch.ops.ell_spmm import _layout_args
    from recbole_gnn_tpu_torch.quick_start import (create_dataset,
                                                   data_preparation,
                                                   run_recbole_gnn_tpu)
    from recbole_gnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                       params_from_numpy)
    from recbole_gnn_tpu_torch.train.trainer import Trainer
    cd = general_config(tmp, model_name, **(over or {}))
    if label:
        ck = os.path.join(tmp, f"{label}-ell")
        cd.update(checkpoint_dir=ck,
                  metrics_log_path=os.path.join(ck, "train.jsonl"))
    bf16 = str(cd.get("activation_dtype", "")).startswith("bf")
    tag = f"{label or model_name} ell"
    if over:
        log(f"[{tag}] config {json.dumps(over)}")
    epochs = cd["epochs"]
    if model_name in GENERAL_OVERRIDES:
        over, why = GENERAL_OVERRIDES[model_name]
        log(f"[{tag}] override {json.dumps(over)}: {why}")
    torch.cuda.reset_peak_memory_stats()
    # what earlier runs of this process still hold: the run's own peak
    # is the peak above it
    held_bytes = torch.cuda.memory_allocated()
    builds0 = _layout_args.builds
    reset_counts()
    t0 = time.perf_counter()
    res = run_recbole_gnn_tpu(model=model_name, dataset="gowalla_shape",
                              config_dict=cd, saved=True, verbose=False)
    wall = time.perf_counter() - t0
    lap = lap_timer()
    counts = read_counts()
    layout_builds = _layout_args.builds - builds0
    peak_bytes = torch.cuda.max_memory_allocated()
    with open(cd["metrics_log_path"]) as f:
        events = [json.loads(line) for line in f]
    config = Config(model=model_name, dataset="gowalla_shape", config_dict=cd)
    (train_loader, train_ds), (valid_loader, _), _ = data_preparation(
        config, create_dataset(config))
    model = get_model(model_name)(config, train_ds, dev)
    lap(f"[{tag}] dataset, loaders and model rebuilt")
    steps = len(train_loader)
    epoch_events = [e for e in events if e["event"] == "train_epoch"]
    valids = [e for e in events if e["event"] == "valid"]
    losses = [e["loss"] for e in epoch_events]
    log(f"[{tag}] train: {steps} steps per epoch of "
        f"{train_loader.batch_size} pairs; {epochs} epochs in {wall:.1f} s "
        "end to end")
    for e in epoch_events:
        log(f"[{tag}] train epoch {e['epoch']}: loss {e['loss']:.6f}, "
            f"{e['seconds']:.3f} s, {e['examples_per_s']:.0f} examples/s")
    for e in valids:
        log(f"[{tag}] valid epoch {e['epoch']}: {e['seconds']:.3f} s, "
            f"recall@10 {e['recall@10']:.5f}, ndcg@10 {e['ndcg@10']:.5f}")
    log(f"[{tag}] test: {res['test_result']}")
    if len(losses) != epochs or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[{tag}] training losses: {losses}")
    for e in valids:
        check_metrics(f"[{tag}] valid epoch {e['epoch']}",
                      {k: v for k, v in e.items() if "@" in k})
    check_metrics(f"[{tag}] test", res["test_result"])
    n_evals = len(valids) + 1
    issued = fit_steps(tag, epochs * steps)["issued"]
    prop = GENERAL_STEP_SPMMS[model_name] * issued
    want = {k: 0 for k in counters()}
    want.update(ell_spmm=prop + GENERAL_EVAL_SPMMS[model_name] * n_evals,
                ell_spmm_transpose=prop, **nce_counts(model_name, issued))
    log(f"[{tag}] train launches: {counts} (expected {want}: "
        f"{GENERAL_STEP_SPMMS[model_name]} K2 and as many K2T per step x "
        f"{issued} steps + {GENERAL_EVAL_SPMMS[model_name]} K2 x "
        f"{n_evals} evaluations; "
        f"{GENERAL_STEP_NCES.get(model_name, 0)} InfoNCE pair calls per "
        "step)")
    if counts != want:
        raise AssertionError(f"[{tag}] training launch counts differ")
    log(f"[{tag}] layouts whose kernel arguments were made in the run "
        f"(_layout_args.builds): {layout_builds}")
    if model_name == "SGL":
        # the graph's two layouts once, then per epoch each view's two
        # (ED: one layout serves all three layers), never per step
        if layout_builds != 2 + 2 * 2 * epochs:
            raise AssertionError(
                f"[{tag}] {layout_builds} layout argument builds in "
                f"{epochs} epoch(s) of {steps} steps; expected "
                f"{2 + 4 * epochs}")
    log(f"[{tag}] train peak device memory (max_memory_allocated): "
        f"{peak_bytes} bytes ({peak_bytes / 2**30:.3f} GiB), "
        f"{peak_bytes - held_bytes} above the {held_bytes} bytes that "
        "earlier runs of the process hold")

    ckpt = os.path.join(cd["checkpoint_dir"],
                        f"{model_name}-gowalla_shape.ckpt")
    state = load_checkpoint(ckpt)
    mode = int(model.loss_mode(epochs - 1))
    trainer = Trainer(config, model)
    lap(f"[{tag}] checks of the run")
    params = params_from_numpy(state["params"], dev)
    extras = params_from_numpy(state.get("extras") or {}, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = trainer.evaluator.evaluate(params, extras, valid_loader)
    eval_s = time.perf_counter() - t0
    log(f"[{tag}] full-sort evaluation of {len(valid_loader.eval_users)} "
        f"valid users x {model.n_items} items (host clock): {eval_s:.3f} s")
    check_metrics(f"[{tag}] re-evaluation", result)
    step_err = None
    if GENERAL_STEP_SPMMS[model_name]:
        n = GENERAL_STEP_SPMMS[model_name]
        batch = to_device(next(iter(train_loader)), dev)
        step_err = general_step_vs_plain(
            model, params, extras, batch, mode,
            {"ell_spmm": n, "ell_spmm_transpose": n,
             **nce_counts(model_name)}, tag, bf16)
        log(f"[{tag}] step vs plain (loss mode {mode}): " + ", ".join(
            f"{k} {v:.6e}" for k, v in step_err.items()))
    lap(f"[{tag}] evaluation and step vs plain")
    summary = {"epochs": epochs, "steps_per_epoch": steps,
               "batch": train_loader.batch_size,
               "epoch_s": [e["seconds"] for e in epoch_events],
               "examples_per_s": [e["examples_per_s"] for e in epoch_events],
               "losses": losses, "run_s": wall,
               "peak_bytes": peak_bytes,
               "run_peak_bytes": peak_bytes - held_bytes, "eval_s": eval_s,
               "valid_recall@10": [e["recall@10"] for e in valids],
               "test": res["test_result"], "layout_builds": layout_builds,
               "step_vs_plain": step_err}
    return {"config": config, "ckpt": ckpt,
            "graph": model.consts.get("graph"), "params": params,
            "extras": extras, "counts": counts, "summary": summary}


def general_extra_steps(tmp: str, runs: dict, dev) -> dict:
    """The step checks of the general family's other impls, on the
    trained params: NGCF with ``node_dropout: 0.1`` on an ell config
    (each step re-weights the graph, which then runs ``xla``: D2 and D1
    once per layer forward and back) and LightGCL on ``pallas`` (K1 and
    K1T on its rectangular graphs)."""
    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    from recbole_gnn_tpu_torch.models import get_model
    from recbole_gnn_tpu_torch.quick_start import (create_dataset,
                                                   data_preparation)
    out = {}
    for name, model_name, impl, over, want in (
            ("NGCF xla", "NGCF", "ell", {"node_dropout": 0.1},
             {"row_gather": 6, "block_segment_sum": 6}),
            ("LightGCL pallas", "LightGCL", "pallas", {},
             {"segment_spmm": 4, "segment_spmm_transpose": 4})):
        cd = general_config(tmp, model_name, impl, **over)
        config = Config(model=model_name, dataset="gowalla_shape",
                        config_dict=cd)
        (train_loader, train_ds), _, _ = data_preparation(
            config, create_dataset(config))
        model = get_model(model_name)(config, train_ds, dev)
        run = runs[model_name]
        batch = to_device(next(iter(train_loader)), dev)
        out[name] = general_step_vs_plain(model, run["params"], run["extras"],
                                          batch, 0, want, name)
        log(f"[{name}] step vs plain: " + ", ".join(
            f"{k} {v:.6e}" for k, v in out[name].items()))
        del model
    return out


def sgl_bf16_phase(tmp: str, f32_run: dict, dev) -> dict:
    """SGL with ``activation_dtype: bfloat16``: its run on ``ell`` as the
    general models' (:func:`general_path`: every count exact, the step
    held against the plain step), its test ndcg@10 and recall@10 within
    SGL_BF16_METRIC_BAND of the f32 run's, its peak memory beside the
    f32 run's, its export and serving; then SGL_BF16_STEPS steps on each
    of SGL_BF16_GRAPHS from the trained params, the launches held and
    each step against its plain one (dense: against the f32 step from
    the bf16-rounded embeddings, the tables within 1e-6 of theirs).
    Returns the launch counts by path."""
    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    from recbole_gnn_tpu_torch.models import get_model
    from recbole_gnn_tpu_torch.quick_start import (create_dataset,
                                                   data_preparation)
    t0 = time.perf_counter()
    paths = {}
    with capped_train_steps(GENERAL_TRAIN_STEPS):
        run = general_path(tmp, "SGL", dev, over=SGL_BF16, label="SGL-bf16")
    paths["sgl_bf16_train"] = run["counts"]
    got, want = run["summary"], f32_run["summary"]
    for k in ("ndcg@10", "recall@10"):
        gap = abs(got["test"][k] - want["test"][k])
        log(f"[SGL-bf16] test {k} {got['test'][k]:.5f} against f32 "
            f"{want['test'][k]:.5f}: gap {gap:.5f}")
        if not gap < SGL_BF16_METRIC_BAND:
            raise AssertionError(f"[SGL-bf16] test {k} {gap:.5f} from the "
                                 "f32 run")
    log(f"[SGL-bf16] train peak device memory above what the process "
        f"held before the run: {got['run_peak_bytes']} bytes against f32 "
        f"SGL's {want['run_peak_bytes']} "
        f"({got['run_peak_bytes'] / want['run_peak_bytes']:.3f}x)")
    paths["sgl_bf16_serve"] = serve_path(run, tmp, "ell", dev,
                                         batches=(1, 64), label="SGL-bf16")
    params = run["params"]
    for impl, over, want_counts in SGL_BF16_GRAPHS:
        tag = f"SGL-bf16 {impl}"
        if impl == "dense":
            log(f"[{tag}] override {json.dumps(over)}: the Gowalla block "
                "is above the default dense threshold")
        cd = general_config(tmp, "SGL", **SGL_BF16, **over)
        config = Config(model="SGL", dataset="gowalla_shape", config_dict=cd)
        (loader, ds), _, _ = data_preparation(config, create_dataset(config))
        model = get_model("SGL")(config, ds, dev)
        extras = model.init_extras(torch.Generator().manual_seed(SEED))
        it = iter(loader)
        for i in range(SGL_BF16_STEPS):
            batch = to_device(next(it), dev)
            if impl == "dense":
                err = dense_bf16_step(model, params, extras, batch, tag)
            else:
                err = general_step_vs_plain(model, params, extras, batch, 0,
                                            want_counts, tag, bf16=True)
            log(f"[{tag}] step {i} vs plain: " + ", ".join(
                f"{k} {v:.6e}" for k, v in err.items()))
        paths[f"sgl_bf16_{impl}_steps"] = {
            k: want_counts.get(k, 0) * SGL_BF16_STEPS for k in counters()}
        del model, extras, ds, loader
        torch.cuda.empty_cache()
    log(f"SGL bf16 phase: {time.perf_counter() - t0:.1f} s")
    return paths


def dense_bf16_step(model, params: dict, extras: dict, batch: dict,
                    tag: str) -> dict:
    """SGL's bf16 step on the dense graph, which launches no SpMM kernel
    of the port (only the InfoNCE pair, 2 / 2 calls a step, on both
    sides): the first layer's f32 product of the bf16 input (JAX's
    promotion) is the f32 product of the bf16-rounded embeddings, so
    the propagated tables must equal those of the f32 model from the
    rounded embeddings (within 1e-6 of their largest |entry|: the same
    cuBLAS products), and the step its step (:func:`hold_step`'s bf16
    bounds: the reg term reads the unrounded params)."""
    rounded = {k: v.detach().to(torch.bfloat16).float()
               for k, v in params.items()}
    reset_counts()
    k_step = step_loss_and_grads(model, params, extras, batch, 0)
    with torch.no_grad():
        tables = model.propagate(params, model.consts, extras)
    got = {k: v for k, v in read_counts().items() if v}
    if got != nce_counts("SGL"):
        raise AssertionError(f"[{tag}] the dense step launched {got}, "
                             f"expected {nce_counts('SGL')}")
    model.act_dtype = None
    try:
        f_step = step_loss_and_grads(model, rounded, extras, batch, 0)
        with torch.no_grad():
            f_tables = model.propagate(rounded, model.consts, extras)
    finally:
        model.act_dtype = torch.bfloat16
    for a, b in zip(tables, f_tables):
        if a.dtype != torch.float32 or not bool(
                ((a - b).abs() <= 1e-6 * b.abs().max()).all()):
            raise AssertionError(f"[{tag}] the bf16 tables ({a.dtype}) "
                                 "differ from the f32 ones of the rounded "
                                 "embeddings")
    return hold_step(tag, "f32 rounded", k_step, f_step, bf16=True)


def general_main(tmp: str, out_path: str) -> int:
    """The general-models phase (a child process of :func:`main`, on
    the data ``main`` wrote in ``tmp``): each model's path, SGL's
    serving, NeuMF's refused export and the other impls' step checks;
    writes the launch counts by path to ``out_path``."""
    from recbole_gnn_tpu_torch.ops import cuda_build
    from recbole_gnn_tpu_torch.serve import export_artifact
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cuda_build.build(SOURCES)              # built by main: loads only
    paths, general = {}, {}
    lap = lap_timer()
    for model_name in GENERAL_MODELS:
        with (capped_train_steps(GENERAL_TRAIN_STEPS)
              if model_name not in GENERAL_FULL_EPOCHS
              else contextlib.nullcontext()):
            run = general_path(tmp, model_name, dev)
        paths[f"{model_name.lower()}_train"] = run["counts"]
        general[model_name] = run
        lap(f"[{model_name} ell] path")
    paths["sgl_serve"] = serve_path(general["SGL"], tmp, "ell", dev)
    lap("[SGL ell] serve")
    paths.update(sgl_bf16_phase(tmp, general["SGL"], dev))
    lap("SGL bf16 phase")
    try:
        export_artifact(general["NeuMF"]["config"],
                        os.path.join(tmp, "neumf.npz"),
                        checkpoint_path=general["NeuMF"]["ckpt"], device=dev)
    except ValueError as e:
        log(f"[NeuMF] export refused, as the JAX package refuses it: {e}")
    else:
        raise AssertionError("NeuMF's export did not raise")
    general_steps = general_extra_steps(tmp, general, dev)
    lap("NeuMF export and the other impls' step checks")
    log(json.dumps({"general_models": {
        m: r["summary"] for m, r in general.items()},
        "general_step_vs_plain_other_impls": general_steps}))
    with open(out_path, "w") as f:
        json.dump({"paths": paths}, f)
    return 0


def run_general_phase(tmp: str) -> dict:
    """Run :func:`general_main` in a child process on ``tmp``'s data;
    its output goes to this process's; a failure there fails here."""
    out_path = os.path.join(tmp, "general_phase.json")
    t0 = time.perf_counter()
    sys.stdout.flush()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--general", tmp, out_path])
    if r.returncode != 0:
        raise AssertionError(f"the general-models phase failed "
                             f"(exit {r.returncode})")
    log(f"general-models phase: {time.perf_counter() - t0:.1f} s")
    with open(out_path) as f:
        return json.load(f)


# -- the session family -------------------------------------------------------

SESSION_MODELS = ("SRGNN", "NISER", "TAGNN", "GCSAN", "SGNNHN", "GRU4Rec",
                  "NARM", "SASRec", "GCEGNN", "LESSR")
SESSION_SERVED = ("SRGNN", "SASRec", "GCEGNN", "LESSR")
SESSION_BATCHES = (1, 8, 64, 256)
SESSION_SERVE_CHECKED = 512        # test sessions held against the evaluator
# one step on the card against the same step on the CPU: the same f32
# terms summed in another order (cuBLAS and the CPU's BLAS), through at
# most 6 cells (SGNNHN) or 20 GRU steps; gradients |Δ| ≤ 1e-4·max|g|
# over every leaf of the step, the logits 1e-4 of their max, the loss
# rtol 1e-4
SESSION_STEP_RTOL = 1e-4
SESSION_STEP_ATOL_FRAC = 1e-4
# LESSR's PReLUs take the outputs of masked BatchNorms, centred on 0, so
# the devices' f32 rounding puts an input on the other side of 0 now and
# then (on an H100 one of 21M inputs moved a gradient by 1.85e-5 against
# the bound's 1.4e-6; in float64 no input crossed and the two agreed to
# 4.9e-17): the CPU step takes each PReLU's branch from the card step,
# and fails if more than this many of its own inputs would have taken
# the other branch (an activation fault flips far more than rounding)
SESSION_STEP_MAX_FLIPS = 8


def session_config(tmp: str, model: str) -> dict:
    """``examples/diginetica.yaml``'s settings (the model's yaml for the
    rest), one epoch; the dataset and its splits cached for the next
    model; each model in its own checkpoint directory."""
    ck = os.path.join(tmp, f"{model}-session")
    return {"data_path": tmp, "checkpoint_dir": ck,
            "USER_ID_FIELD": "session_id", "ITEM_ID_FIELD": "item_id",
            "TIME_FIELD": "timestamp",
            "load_col": {"inter": ["session_id", "item_id", "timestamp"]},
            "user_inter_num_interval": "[5,inf)",
            "item_inter_num_interval": "[5,inf)",
            "MAX_ITEM_LIST_LENGTH": 20, "train_batch_size": 4096,
            "eval_batch_size": 2000, "valid_metric": "MRR@10",
            "eval_args": {"split": {"LS": "valid_and_test"}, "mode": "full",
                          "order": "TO"},
            "metrics": ["Recall", "MRR", "NDCG", "Hit", "Precision"],
            "topk": [10], "embedding_size": 64, "epochs": 1, "eval_step": 1,
            "seed": SEED, "state": "ERROR", "save_dataset": True,
            "save_dataloaders": True,
            "metrics_log_path": os.path.join(ck, "train.jsonl")}


def check_native_builder(config) -> dict:
    """The dataset's session graphs came from the C++ builder, and its
    arrays equal the numpy path's on every split of the whole dataset."""
    from recbole_gnn_tpu_torch import native
    from recbole_gnn_tpu_torch.data.session import (SessionGraphDataset,
                                                    _alias_per_row,
                                                    _unique_per_row)
    from recbole_gnn_tpu_torch.quick_start import (create_dataset,
                                                   data_preparation)
    if not native.native_available():
        raise AssertionError("the native session-graph builder did not "
                             "build or load")
    t0 = time.perf_counter()
    splits = data_preparation(config, create_dataset(config))
    build_s = time.perf_counter() - t0
    rows, native_s, numpy_s = 0, 0.0, 0.0
    for _, ds in splits:
        seqs = ds.inter[ds.item_list_field]
        lens = ds.inter[ds.item_length_field]
        L = ds.max_seq_len
        t0 = time.perf_counter()
        got = native.build_session_graphs_native(seqs, lens)
        native_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        x, n_nodes = _unique_per_row(seqs)
        alias = _alias_per_row(x, n_nodes, seqs, lens)
        src, dst, n_edges = SessionGraphDataset._consecutive_edges(
            alias, lens, L)
        numpy_s += time.perf_counter() - t0
        want = (x, n_nodes, alias, src, dst, n_edges)
        names = ("x", "n_nodes", "alias_inputs", "edge_src", "edge_dst",
                 "n_edges")
        for name, g, w in zip(names, got, want):
            if not np.array_equal(g, w) or not np.array_equal(
                    ds.session_graphs[name], w):
                raise AssertionError(f"native session graphs differ from "
                                     f"the numpy path's in {name}")
        rows += len(seqs)
    out = {"sessions": rows, "native_s": native_s, "numpy_s": numpy_s,
           "dataset_and_splits_s": build_s,
           "library": native.library_path()}
    log(f"[session data] native builder == numpy path on all {rows} "
        f"augmented sessions of the three splits (native {native_s:.3f} s, "
        f"numpy {numpy_s:.3f} s); dataset + splits built in {build_s:.1f} s")
    return out


def session_step_vs_cpu(name: str, model, cpu_model, params: dict,
                        host_batch: dict, dev) -> dict:
    """One training step (loss and every gradient) and the train=False
    logits on the card against the same on the CPU, from the same params
    and batch; a dropout model's masks are drawn on the card and
    replayed on the CPU, and so are LESSR's PReLU branches.  Raises past
    the SESSION_STEP_* tolerances."""
    import inspect

    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    from recbole_gnn_tpu_torch.models.layers import KeepStream
    from recbole_gnn_tpu_torch.models.sequential import lessr
    from recbole_gnn_tpu_torch.train.optim import tree_leaves, tree_map

    dropout = "keeps" in inspect.signature(model.calculate_loss).parameters
    stream = (KeepStream(torch.Generator(device=dev).manual_seed(SEED))
              if dropout else None)

    real_prelu = lessr._prelu
    signs, replay = [], {"next": 0, "flips": 0}

    def prelu(alpha, x):
        if x.is_cuda:                   # the card step records each branch
            signs.append((x >= 0).detach())
            return real_prelu(alpha, x)
        card = signs[replay["next"]].cpu()    # the CPU step replays them
        replay["next"] += 1
        replay["flips"] += int((card != (x >= 0)).sum())
        return torch.where(card, x, alpha * x)

    def run(m, p, batch, keeps):
        p = tree_map(lambda v: v.detach().clone().requires_grad_(True), p)
        kw = {} if keeps is None else {"keeps": keeps}
        if name == "LESSR":
            lessr._prelu = prelu
        try:
            loss, _ = m.calculate_loss(p, m.consts, {}, batch, None, **kw)
            grads = torch.autograd.grad(loss, tree_leaves(p),
                                        allow_unused=True)
            with torch.no_grad():
                logits = m.full_scores(p, m.consts, {}, batch, None, False)
        finally:
            lessr._prelu = real_prelu
        return loss.detach().cpu(), [None if g is None else g.cpu()
                                     for g in grads], logits.cpu()

    t0 = time.perf_counter()
    k_loss, k_grads, k_logits = run(model, params, to_device(host_batch, dev),
                                    stream)
    card_s = time.perf_counter() - t0
    cpu_params = tree_map(lambda v: v.detach().cpu(), params)
    t0 = time.perf_counter()
    c_loss, c_grads, c_logits = run(
        cpu_model, cpu_params, to_device(host_batch, "cpu"),
        None if stream is None else [k.cpu() for k in stream.drawn])
    cpu_s = time.perf_counter() - t0
    out = {"loss_card": float(k_loss), "loss_cpu": float(c_loss),
           "loss_abs_err": float((k_loss - c_loss).abs()),
           "keep_masks": 0 if stream is None else len(stream.drawn),
           "replayed_branches": len(signs),
           "branch_flips": replay["flips"],
           "card_s": card_s, "cpu_s": cpu_s}
    if replay["flips"] > SESSION_STEP_MAX_FLIPS:
        raise AssertionError(f"[{name}] {replay['flips']} PReLU inputs on "
                             f"the CPU lie across 0 from the card's: {out}")
    if not out["loss_abs_err"] <= SESSION_STEP_RTOL * abs(out["loss_cpu"]):
        raise AssertionError(f"[{name}] card step loss differs from the "
                             f"CPU's: {out}")
    # every leaf within 1e-4 of the largest gradient entry of the step:
    # a leaf whose true gradient is 0 (the attention's key bias) holds
    # only rounding noise, which no bound relative to itself can hold
    g_max = max(float(cg.abs().max()) for cg in c_grads if cg is not None)
    lim = SESSION_STEP_ATOL_FRAC * g_max
    worst = 0.0
    for i, (kg, cg) in enumerate(zip(k_grads, c_grads)):
        if (kg is None) != (cg is None):
            raise AssertionError(f"[{name}] gradient {i} used on one side")
        if kg is None:
            continue
        err = float((kg - cg).abs().max())
        if not (err <= lim and bool(torch.isfinite(kg).all())):
            raise AssertionError(f"[{name}] card gradient of leaf {i} "
                                 f"differs from the CPU's: max |err| {err:.3e}"
                                 f" > {lim:.3e}")
        worst = max(worst, err)
    err = float((k_logits - c_logits).abs().max())
    lim = SESSION_STEP_ATOL_FRAC * float(c_logits.abs().max())
    if not err <= lim:
        raise AssertionError(f"[{name}] card logits differ from the CPU's: "
                             f"max |err| {err:.3e} > {lim:.3e}")
    out.update(grad_max_abs_err=worst, grad_max_abs=g_max,
               logits_max_abs_err=err,
               logits_max_abs=float(c_logits.abs().max()),
               grad_leaves=len(k_grads))
    return out


def session_path(tmp: str, model_name: str, dev) -> dict:
    """Train ``model_name`` for one epoch through ``run_recbole_gnn_tpu``
    with every counter set to 0 just before and read just after (the
    dense session path launches no kernel of the port); check the run,
    the fall of the loss over the epoch (the CE of a fixed batch from the
    initial params and from the trained checkpoint), the metrics, a
    re-evaluation of its checkpoint, one step on the card against the
    CPU."""
    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    from recbole_gnn_tpu_torch.models import get_model
    from recbole_gnn_tpu_torch.models.losses import cross_entropy
    from recbole_gnn_tpu_torch.quick_start import (create_dataset,
                                                   data_preparation,
                                                   run_recbole_gnn_tpu)
    from recbole_gnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                       params_from_numpy)
    from recbole_gnn_tpu_torch.train.trainer import Trainer
    cd = session_config(tmp, model_name)
    tag = f"{model_name} session"
    # the dataset class and its loaders, built here (or read from the
    # cache an earlier model of the same class wrote) before the run
    config = Config(model=model_name, dataset="diginetica_shape",
                    config_dict=cd)
    t0 = time.perf_counter()
    (train_loader, train_ds), (valid_loader, _), (test_loader, _) = \
        data_preparation(config, create_dataset(config))
    data_s = time.perf_counter() - t0
    log(f"[{tag}] {type(train_ds).__name__} and its loaders: {data_s:.1f} s "
        "(built, or read from the cache an earlier model of the class "
        "wrote)")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = run_recbole_gnn_tpu(model=model_name, dataset="diginetica_shape",
                              config_dict=cd, saved=True, verbose=False)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    with open(cd["metrics_log_path"]) as f:
        events = [json.loads(line) for line in f]
    model = get_model(model_name)(config, train_ds, dev)
    steps = len(train_loader)
    epoch_events = [e for e in events if e["event"] == "train_epoch"]
    valids = [e for e in events if e["event"] == "valid"]
    losses = [e["loss"] for e in epoch_events]
    log(f"[{tag}] train: {steps} steps of {train_loader.batch_size} "
        f"sessions ({train_ds.inter_num} training sessions, "
        f"{model.n_items} items); 1 epoch in {wall:.1f} s end to end")
    for e in epoch_events:
        log(f"[{tag}] train epoch {e['epoch']}: summed loss "
            f"{e['loss']:.4f}, {e['seconds']:.3f} s, "
            f"{e['examples_per_s']:.0f} sessions/s")
    for e in valids:
        log(f"[{tag}] valid epoch {e['epoch']}: {e['seconds']:.3f} s, "
            f"recall@10 {e['recall@10']:.5f}, mrr@10 {e['mrr@10']:.5f}")
    log(f"[{tag}] test: {res['test_result']}")
    if len(losses) != 1 or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[{tag}] training losses: {losses}")
    for e in valids:
        check_metrics(f"[{tag}] valid epoch {e['epoch']}",
                      {k: v for k, v in e.items() if "@" in k})
    check_metrics(f"[{tag}] test", res["test_result"])
    if model_name == "SRGNN" and not res["test_result"]["recall@10"] > 0:
        raise AssertionError(f"[{tag}] test recall@10 is 0")
    want = {k: 0 for k in counters()}
    log(f"[{tag}] train launches: {counts} (expected none: the dense "
        "session path runs no kernel of the port)")
    if counts != want:
        raise AssertionError(f"[{tag}] training launch counts differ")
    log(f"[{tag}] train peak device memory (max_memory_allocated): "
        f"{peak_bytes} bytes ({peak_bytes / 2**30:.3f} GiB)")

    ckpt = os.path.join(cd["checkpoint_dir"],
                        f"{model_name}-diginetica_shape.ckpt")
    state = load_checkpoint(ckpt)
    params = params_from_numpy(state["params"], dev)
    # LESSR's: the BatchNorm statistics its evaluation used
    extras = params_from_numpy(state.get("extras") or {}, dev)
    # the loss over the epoch: CE of one fixed batch (train=False) from
    # the params fit() started with and from the trained checkpoint
    host_batch = next(iter(train_loader))
    fixed = to_device(host_batch, dev)
    init = model.init_params(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        ce = [float(cross_entropy(model.full_scores(p, model.consts, {},
                                                    fixed, None, False),
                                  fixed["item_id"], fixed["weight"]))
              for p in (init, params)]
    log(f"[{tag}] CE of the first training batch: {ce[0]:.5f} from the "
        f"initial params, {ce[1]:.5f} after the epoch")
    if not (all(map(math.isfinite, ce)) and ce[1] < ce[0]):
        raise AssertionError(f"[{tag}] the loss did not fall: {ce}")
    trainer = Trainer(config, model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = trainer.evaluator.evaluate(params, extras, valid_loader)
    eval_s = time.perf_counter() - t0
    log(f"[{tag}] full-sort evaluation of {valid_loader.n} valid sessions x "
        f"{model.n_items} items (host clock): {eval_s:.3f} s")
    best = valids[-1]
    for k, v in result.items():
        if not abs(v - best[k]) <= 1e-6:
            raise AssertionError(f"[{tag}] re-evaluation of the checkpoint: "
                                 f"{k} {v} differs from its validation "
                                 f"{best[k]}")
    cpu_model = get_model(model_name)(config, train_ds, "cpu")
    step_err = session_step_vs_cpu(
        model_name, model, cpu_model, params,
        {k: v[:SESSION_STEP_ROWS] for k, v in host_batch.items()}, dev)
    log(f"[{tag}] card step vs CPU step: " + ", ".join(
        f"{k} {v:.6e}" if isinstance(v, float) else f"{k} {v}"
        for k, v in step_err.items()))
    summary = {"steps_per_epoch": steps, "batch": train_loader.batch_size,
               "epoch_s": [e["seconds"] for e in epoch_events],
               "sessions_per_s": [e["examples_per_s"] for e in epoch_events],
               "losses": losses, "ce_fixed_batch": ce, "run_s": wall,
               "peak_bytes": peak_bytes, "eval_s": eval_s, "data_s": data_s,
               "valid": {k: v for k, v in valids[-1].items() if "@" in k},
               "test": res["test_result"], "card_vs_cpu": step_err}
    return {"config": config, "ckpt": ckpt, "model": model,
            "params": params, "counts": counts, "test_loader": test_loader,
            "train_loader": train_loader, "summary": summary}


def session_serve(run: dict, name: str, dev) -> dict:
    """``SessionServer`` from the trained checkpoint, every counter set to
    0 before and read after: its top-k for SESSION_SERVE_CHECKED test
    sessions against the evaluator's full sort of the same sessions
    (equal up to ties within rounding), ``recommend`` latency at
    SESSION_BATCHES (k = 10) and one HTTP round trip."""
    from recbole_gnn_tpu_torch.data.session import reverse_sessions
    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    from recbole_gnn_tpu_torch.ops.topk import NEG_INF
    from recbole_gnn_tpu_torch.serve import SessionServer
    tag = f"{name} serve"
    reset_counts()
    t0 = time.perf_counter()
    srv = SessionServer(run["config"], checkpoint_path=run["ckpt"])
    start_s = time.perf_counter() - t0
    model = run["model"]
    sessions, want_idx, want_vals = [], [], []
    for batch in run["test_loader"]:
        rows = np.flatnonzero(batch["weight"] > 0)
        with torch.no_grad():
            # LESSR with the statistics the server calibrated
            scores = model.full_scores(run["params"], model.consts,
                                       srv.extras, to_device(batch, dev),
                                       None, False)
            scores[:, 0] = NEG_INF
            v, i = torch.topk(scores, TOP_K)
        seqs = batch["item_seq"]
        if name == "GCEGNN":      # trained on reversed sessions
            seqs = reverse_sessions(seqs, batch["item_seq_len"])
        for r in rows[:SESSION_SERVE_CHECKED - len(sessions)]:
            n = int(batch["item_seq_len"][r])
            sessions.append([str(srv.item_tokens[j]) for j in seqs[r][:n]])
            want_idx.append(i[r].cpu().numpy())
            want_vals.append(v[r].cpu().numpy())
        if len(sessions) >= SESSION_SERVE_CHECKED:
            break
    got_idx, got_vals = srv.recommend(sessions, k=TOP_K,
                                      return_tokens=False)
    want_idx, want_vals = np.array(want_idx), np.array(want_vals)
    same_rows = int((got_idx == want_idx).all(axis=1).sum())
    scale = float(np.abs(want_vals).max())
    if (got_idx == 0).any() or not np.allclose(
            got_vals, want_vals, rtol=1e-5, atol=1e-5 * scale):
        raise AssertionError(f"[{tag}] served top-k values differ from the "
                             "evaluator's")
    for r in np.flatnonzero((got_idx != want_idx).any(axis=1)):
        # a different order only among scores equal within rounding
        diff = got_idx[r] != want_idx[r]
        if not np.allclose(got_vals[r][diff], want_vals[r][diff],
                           rtol=1e-5, atol=1e-5 * scale):
            raise AssertionError(f"[{tag}] row {r}: served top-k "
                                 f"{got_idx[r]} != evaluator's {want_idx[r]}")
    log(f"[{tag}] top-{TOP_K} of {len(sessions)} test sessions equals the "
        f"evaluator's full sort ({same_rows} rows in the same order, the "
        "rest reordered among ties within 1e-5); server start "
        f"{start_s:.1f} s")
    lat = {}
    rng = np.random.default_rng(SEED)
    for b in SESSION_BATCHES:
        reqs = 50 if b <= 64 else 20
        picks = [[sessions[j] for j in rng.integers(0, len(sessions), b)]
                 for _ in range(reqs + 3)]
        for p in picks[:3]:
            srv.recommend(p, k=TOP_K)                 # warm-up
        times = []
        for p in picks[3:]:
            t0 = time.perf_counter()
            srv.recommend(p, k=TOP_K)
            times.append((time.perf_counter() - t0) * 1e3)
        lat[b] = {"p50_ms": float(np.percentile(times, 50)),
                  "p99_ms": float(np.percentile(times, 99)),
                  "requests": reqs}
    out = http_roundtrip(srv, sessions[:3], TOP_K, key="sessions")
    items, _ = srv.recommend(sessions[:3], k=TOP_K)
    if out["items"] != items:
        raise AssertionError(f"[{tag}] the HTTP answer differs from "
                             "recommend's")
    invariance = None
    if hasattr(srv.model, "serving_calibrate"):
        # calibrated scores: one session's alone and among 255 others
        i1, v1 = srv.recommend(sessions[:1], k=TOP_K, return_tokens=False)
        i256, v256 = srv.recommend(sessions[:256], k=TOP_K,
                                   return_tokens=False)
        err = float(np.abs(v1[0] - v256[0]).max())
        lim = 1e-5 * float(np.abs(v256[0]).max())
        diff = i1[0] != i256[0]           # a reorder only among ties
        if not err <= lim or not np.allclose(v1[0][diff], v256[0][diff],
                                             rtol=0, atol=lim):
            raise AssertionError(f"[{tag}] the calibrated scores of one "
                                 f"session differ at B = 1 and B = 256: "
                                 f"{err:.3e} > {lim:.3e}")
        invariance = err
        log(f"[{tag}] one session's calibrated top-{TOP_K} at B = 1 and "
            f"B = 256: max |score difference| {err:.3e} (limit {lim:.3e})")
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"[{tag}] serving launched {counts}")
    log(f"[{tag}] recommend latency by batch (ms, host clock, k={TOP_K}): "
        f"{json.dumps(lat)}; http: {len(out['items'])} sessions answered")
    return {"counts": counts, "latency": lat, "same_rows": same_rows,
            "checked": len(sessions), "start_s": start_s,
            "batch_invariance_max_abs_err": invariance}


def sparse_cell_on_kernels(run: dict, dev) -> tuple[dict, dict]:
    """The sparse ``srgnn_cell`` over one training batch's disjoint-union
    session graph on ``ell`` (K2 forward, K2T back) and ``pallas`` (K1,
    K1T), each with the counters at 0 before and read after (exactly 2
    forward and 2 transpose launches: the in- and out-graph), held
    against ``srgnn_cell_dense`` on the same batch, values and
    gradients."""
    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    from recbole_gnn_tpu_torch.models.layers import srgnn_cell
    from recbole_gnn_tpu_torch.models.sequential.common import (
        node_embeddings, session_dense_adj, session_union_graphs,
        srgnn_cell_dense)
    host = next(iter(run["train_loader"]))
    batch = to_device(host, dev)
    params = run["params"]
    B, L = host["x"].shape
    D = params["item_emb"].shape[1]
    cell = {k: {n: v.detach().clone().requires_grad_(True)
                for n, v in lin.items()} for k, lin in params["cell"].items()}
    hidden = node_embeddings(params["item_emb"], batch).detach()
    cot = torch.randn(B, L, D, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(SEED))

    def grads_of(out, h):
        leaves = [h, cell["in_conv"]["w"], cell["out_conv"]["w"],
                  cell["lin_ih"]["w"], cell["lin_hh"]["w"]]
        return torch.autograd.grad((out * cot.reshape(out.shape)).sum(),
                                   leaves)

    h = hidden.clone().requires_grad_(True)
    a_in, a_out = session_dense_adj(batch)
    dense = srgnn_cell_dense(cell, h, a_in, a_out)
    d_grads = grads_of(dense, h)
    paths, out = {}, {}
    for impl, want in (("ell", {"ell_spmm": 2, "ell_spmm_transpose": 2}),
                       ("pallas", {"segment_spmm": 2,
                                   "segment_spmm_transpose": 2})):
        in_g, out_g = session_union_graphs(host, device=dev, impl=impl)
        h = hidden.reshape(B * L, D).clone().requires_grad_(True)
        reset_counts()
        sparse = srgnn_cell(cell, h, in_g, out_g)
        s_grads = grads_of(sparse, h)
        torch.cuda.synchronize()
        counts = read_counts()
        got = {k: v for k, v in counts.items() if v}
        if got != want:
            raise AssertionError(f"[srgnn_cell {impl}] launched {got}, "
                                 f"expected {want}")
        paths[f"srgnn_cell_{impl}"] = counts
        err = float((sparse.reshape(B, L, D) - dense).detach().abs().max())
        lim = 1e-5 * float(dense.detach().abs().max())
        if not err <= lim:
            raise AssertionError(f"[srgnn_cell {impl}] differs from the "
                                 f"dense cell: {err:.3e} > {lim:.3e}")
        g_err = 0.0
        for sg, dg in zip(s_grads, d_grads):
            e = float((sg.reshape(dg.shape) - dg).abs().max())
            if not e <= SESSION_STEP_ATOL_FRAC * float(dg.abs().max()):
                raise AssertionError(f"[srgnn_cell {impl}] gradient differs "
                                     f"from the dense cell's: {e:.3e}")
            g_err = max(g_err, e / float(dg.abs().max()))
        out[impl] = {"max_abs_err": err, "grad_max_err_over_max": g_err,
                     "edges": in_g.nnz, "nodes": B * L}
        log(f"[srgnn_cell {impl}] one training batch's union graph "
            f"({B * L} nodes, {in_g.nnz} edges each way): launches {got}; "
            f"max |sparse - dense| {err:.3e}, gradients {g_err:.3e} of max")
    return paths, out


def session_main(tmp: str, out_path: str) -> int:
    """The session phase (a child process of :func:`main`): writes the
    diginetica-shape log into ``tmp``, checks the native builder, trains
    the ten session models, serves SRGNN, SASRec, GCEGNN and LESSR, runs
    the sparse SR-GNN cell on K2 and K1; writes the launch counts by path and the
    summaries to ``out_path``."""
    from recbole_gnn_tpu_torch.diag.diginetica_shape import (
        DIGINETICA_SHAPE, revisit_share, write_diginetica_shape)
    from recbole_gnn_tpu_torch.ops import cuda_build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cuda_build.build(SOURCES)              # built by main: loads only
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    path = write_diginetica_shape(tmp, "diginetica_shape", SEED,
                                  **DIGINETICA_SHAPE)
    log(f"[session data] diginetica-shape log written "
        f"({time.perf_counter() - t0:.1f} s): {DIGINETICA_SHAPE}, revisit "
        f"share {revisit_share(path):.4f}")
    from recbole_gnn_tpu_torch.config import Config
    native_check = check_native_builder(Config(
        model="SRGNN", dataset="diginetica_shape",
        config_dict=session_config(tmp, "SRGNN")))
    paths, runs, summary = {}, {}, {}
    lap = lap_timer()
    for name in SESSION_MODELS:
        with (capped_train_steps(SESSION_TRAIN_STEPS[name])
              if name in SESSION_TRAIN_STEPS else contextlib.nullcontext()):
            run = session_path(tmp, name, dev)
        lap(f"[{name} session] path")
        paths[f"{name.lower()}_train"] = run["counts"]
        summary[name] = run["summary"]
        if name in SESSION_SERVED:        # SRGNN's also feeds the cell
            runs[name] = run
        del run
        torch.cuda.empty_cache()
    serving = {}
    for name in SESSION_SERVED:
        serving[name] = session_serve(runs[name], name, dev)
        paths[f"{name.lower()}_serve"] = serving[name]["counts"]
        lap(f"[{name} serve] path")
    cell_paths, cell = sparse_cell_on_kernels(runs["SRGNN"], dev)
    lap("SR-GNN sparse cell")
    paths.update(cell_paths)
    log(json.dumps({"session_models": summary, "session_serving": serving,
                    "srgnn_cell": cell, "native_builder": native_check,
                    "card": card}))
    with open(out_path, "w") as f:
        json.dump({"paths": paths, "summary": summary, "serving": serving,
                   "srgnn_cell": cell, "card": card}, f)
    return 0


def run_session_phase(tmp: str) -> dict:
    """Run :func:`session_main` in a child process; its output goes to
    this process's; a failure there fails here."""
    out_path = os.path.join(tmp, "session_phase.json")
    t0 = time.perf_counter()
    sys.stdout.flush()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--session", tmp, out_path])
    if r.returncode != 0:
        raise AssertionError(f"the session phase failed (exit "
                             f"{r.returncode})")
    log(f"session phase: {time.perf_counter() - t0:.1f} s")
    with open(out_path) as f:
        return json.load(f)


# -- the social family --------------------------------------------------------

SOCIAL_MODELS = ("DiffNet", "MHCN", "SEPT")
LASTFM_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "lastfm.yaml")
# the departures from examples/lastfm.yaml and the models' yaml (model
# None: every model), each with its reason (logged with the run)
SOCIAL_OVERRIDES = (
    (None, {"enable_sparse": True},
     "at the LastFM shape every matrix fits dense_graph_max_entries and "
     "would run on cuBLAS alone; the sparse path is what larger social "
     "graphs take"),
    ("SEPT", {"warm_up_epochs": 0},
     "tri-training and the per-epoch subgraph start after warm_up_epochs "
     "(100); at 0 both run from epoch 0"),
)
# SEPT's subgraph is re-weighted at the epoch boundary
SOCIAL_EPOCHS = {"SEPT": 2}
# K2 launches per training step (as many K2T) and per evaluation, at 2
# layers: DiffNet the interest aggregation and 2 social layers; MHCN 5
# per layer (3 channels, R_iu, R_ui) and 1 per MIM channel; SEPT in loss
# mode 1 the joint graph, the subgraph, the friend and the sharing views
SOCIAL_STEP_SPMMS = {"DiffNet": 3, "MHCN": 13, "SEPT": 8}
SOCIAL_EVAL_SPMMS = {"DiffNet": 3, "MHCN": 10, "SEPT": 2}
# the kernel arguments made in a run: 2 layouts (forward, transpose) per
# static sparse matrix, and SEPT's subgraph 2 per epoch
SOCIAL_STATIC_MATRICES = {"DiffNet": 2, "MHCN": 5, "SEPT": 3}


def social_config(tmp: str, model: str, impl: str = "ell", **over) -> dict:
    """``examples/lastfm.yaml`` (passed as a config file) with the
    model's yaml, its SOCIAL_OVERRIDES and ``over``; each (model, impl)
    in its own checkpoint directory."""
    ck = os.path.join(tmp, f"{model}-{impl}-social")
    cd = {"data_path": tmp, "checkpoint_dir": ck, "sparse_spmm_impl": impl,
          "epochs": SOCIAL_EPOCHS.get(model, 1), "eval_step": 1,
          "seed": SEED, "state": "ERROR", "save_dataset": True,
          "metrics_log_path": os.path.join(ck, "train.jsonl")}
    for who, o, _ in SOCIAL_OVERRIDES:
        if who in (None, model):
            cd.update(o)
    cd.update(over)
    return cd


def social_model(tmp: str, model_name: str, dev, impl: str = "ell",
                 **over):
    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.models import get_model
    from recbole_gnn_tpu_torch.quick_start import (create_dataset,
                                                   data_preparation)
    config = Config(model=model_name, dataset="lastfm_shape",
                    config_file_list=[LASTFM_YAML],
                    config_dict=social_config(tmp, model_name, impl, **over))
    splits = data_preparation(config, create_dataset(config))
    return config, splits, get_model(model_name)(config, splits[0][1], dev)


def social_counts(impl: str, model_name: str, steps: int,
                  n_evals: int) -> dict:
    """Per step (of those whose kernels went through the wrappers)
    SOCIAL_STEP_SPMMS products forward and as many back, per evaluation
    SOCIAL_EVAL_SPMMS forward: ell K2 forward and K2T back; pallas K1 and
    K1T; xla D2 and D1 once per product each way."""
    prop = SOCIAL_STEP_SPMMS[model_name] * steps
    fwd = prop + SOCIAL_EVAL_SPMMS[model_name] * n_evals
    want = {k: 0 for k in counters()}
    if impl == "ell":
        want.update(ell_spmm=fwd, ell_spmm_transpose=prop)
    elif impl == "pallas":
        want.update(segment_spmm=fwd, segment_spmm_transpose=prop)
    else:
        want.update(row_gather=fwd + prop, block_segment_sum=fwd + prop)
    return want


def social_path(tmp: str, model_name: str, dev, impl: str = "ell") -> dict:
    """Train ``model_name`` through ``run_recbole_gnn_tpu`` on ``impl``
    with every counter set to 0 just before and read just after; check
    the run, its launch counts, its layout-argument builds and a
    re-evaluation of its checkpoint."""
    from recbole_gnn_tpu_torch.ops.ell_spmm import _layout_args
    from recbole_gnn_tpu_torch.quick_start import run_recbole_gnn_tpu
    from recbole_gnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                       params_from_numpy)
    from recbole_gnn_tpu_torch.train.trainer import Trainer
    tag = f"{model_name} social {impl}"
    for who, over, why in SOCIAL_OVERRIDES:
        if who in (None, model_name):
            log(f"[{tag}] override {json.dumps(over)}: {why}")
    t0 = time.perf_counter()
    config, splits, model = social_model(tmp, model_name, dev, impl)
    setup_s = time.perf_counter() - t0
    (train_loader, train_ds), (valid_loader, _), _ = splits
    cd = social_config(tmp, model_name, impl)
    epochs = cd["epochs"]
    torch.cuda.reset_peak_memory_stats()
    builds0 = _layout_args.builds
    reset_counts()
    t0 = time.perf_counter()
    res = run_recbole_gnn_tpu(model=model_name, dataset="lastfm_shape",
                              config_file_list=[LASTFM_YAML],
                              config_dict=cd, saved=True, verbose=False)
    wall = time.perf_counter() - t0
    counts = read_counts()
    layout_builds = _layout_args.builds - builds0
    peak_bytes = torch.cuda.max_memory_allocated()
    with open(cd["metrics_log_path"]) as f:
        events = [json.loads(line) for line in f]
    steps = len(train_loader)
    epoch_events = [e for e in events if e["event"] == "train_epoch"]
    valids = [e for e in events if e["event"] == "valid"]
    losses = [e["loss"] for e in epoch_events]
    sparse = {k: (v.n_nodes, v.n_src_nodes, v.nnz)
              for k, v in model.consts.items() if hasattr(v, "nnz")}
    log(f"[{tag}] dataset, loaders and model built in {setup_s:.1f} s; "
        f"{train_ds.n_users - 1} users, {train_ds.n_items - 1} items, "
        f"{train_ds.net_num} net edges; sparse matrices (rows, cols, nnz) "
        f"{json.dumps(sparse)}; {steps} steps per epoch of "
        f"{train_loader.batch_size} pairs; {epochs} epochs in {wall:.1f} s "
        "end to end")
    for e in epoch_events:
        log(f"[{tag}] train epoch {e['epoch']}: loss {e['loss']:.6f}, "
            f"{e['seconds']:.3f} s, {e['examples_per_s']:.0f} examples/s")
    for e in valids:
        log(f"[{tag}] valid epoch {e['epoch']}: {e['seconds']:.3f} s, "
            f"recall@10 {e['recall@10']:.5f}, mrr@10 {e['mrr@10']:.5f}")
    log(f"[{tag}] test: {res['test_result']}")
    if len(losses) != epochs or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[{tag}] training losses: {losses}")
    for e in valids:
        check_metrics(f"[{tag}] valid epoch {e['epoch']}",
                      {k: v for k, v in e.items() if "@" in k})
    check_metrics(f"[{tag}] test", res["test_result"])
    n_evals = len(valids) + 1
    issued = fit_steps(tag, epochs * steps)["issued"]
    want = social_counts(impl, model_name, issued, n_evals)
    log(f"[{tag}] train launches: {counts} (expected {want}: "
        f"{SOCIAL_STEP_SPMMS[model_name]} products forward and as many "
        f"back per step x {issued} steps + "
        f"{SOCIAL_EVAL_SPMMS[model_name]} forward x {n_evals} evaluations)")
    if counts != want:
        raise AssertionError(f"[{tag}] training launch counts differ")
    want_builds = 0 if impl != "ell" else (
        2 * SOCIAL_STATIC_MATRICES[model_name]
        + (2 * epochs if model_name == "SEPT" else 0))
    log(f"[{tag}] layouts whose kernel arguments were made in the run "
        f"(_layout_args.builds): {layout_builds} (expected {want_builds})")
    if layout_builds != want_builds:
        raise AssertionError(f"[{tag}] {layout_builds} layout argument "
                             f"builds, expected {want_builds}")
    log(f"[{tag}] train peak device memory (max_memory_allocated): "
        f"{peak_bytes} bytes ({peak_bytes / 2**30:.3f} GiB)")

    ckpt = os.path.join(cd["checkpoint_dir"],
                        f"{model_name}-lastfm_shape.ckpt")
    state = load_checkpoint(ckpt)
    mode = int(model.loss_mode(epochs - 1))
    trainer = Trainer(config, model)
    params = params_from_numpy(state["params"], dev)
    extras = params_from_numpy(state.get("extras") or {}, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = trainer.evaluator.evaluate(params, extras, valid_loader)
    eval_s = time.perf_counter() - t0
    log(f"[{tag}] full-sort evaluation of {len(valid_loader.eval_users)} "
        f"valid users x {model.n_items} items (host clock): {eval_s:.3f} s")
    check_metrics(f"[{tag}] re-evaluation", result)
    summary = {"epochs": epochs, "steps_per_epoch": steps,
               "batch": train_loader.batch_size, "setup_s": setup_s,
               "epoch_s": [e["seconds"] for e in epoch_events],
               "examples_per_s": [e["examples_per_s"] for e in epoch_events],
               "losses": losses, "run_s": wall, "loss_mode": mode,
               "peak_bytes": peak_bytes, "eval_s": eval_s,
               "valid_recall@10": [e["recall@10"] for e in valids],
               "test": res["test_result"], "layout_builds": layout_builds}
    return {"config": config, "ckpt": ckpt, "model": model,
            "params": params, "extras": extras, "mode": mode,
            "train_loader": train_loader, "counts": counts,
            "summary": summary}


def social_steps(tmp: str, run: dict, model_name: str, dev) -> dict:
    """One step of the trained model on the K2 kernels against the same
    step on the plain SpMMs and against the dense form's step (the
    model at ``enable_sparse: False``: cuBLAS, where SEPT's subgraph,
    sparse in both forms, runs K2); DiffNet also on ``pallas`` (K1) and
    ``xla`` (D2 + D1) against the plain step."""
    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    tag = f"{model_name} social"
    n = SOCIAL_STEP_SPMMS[model_name]
    batch = to_device(next(iter(run["train_loader"])), dev)
    params, extras, mode = run["params"], run["extras"], run["mode"]
    out = {"ell_vs_plain": general_step_vs_plain(
        run["model"], params, extras, batch, mode,
        {"ell_spmm": n, "ell_spmm_transpose": n}, f"{tag} ell")}
    log(f"[{tag}] ell step vs plain (loss mode {mode}): " + ", ".join(
        f"{k} {v:.6e}" for k, v in out["ell_vs_plain"].items()))
    reset_counts()
    k_step = step_loss_and_grads(run["model"], params, extras, batch, mode)
    _, _, dense = social_model(tmp, model_name, dev, enable_sparse=False)
    reset_counts()
    d_step = step_loss_and_grads(dense, params, extras, batch, mode)
    got = {k: v for k, v in read_counts().items() if v}
    # the dense form keeps SEPT's subgraph sparse (the JAX package's too)
    want = ({"ell_spmm": 2, "ell_spmm_transpose": 2}
            if model_name == "SEPT" else {})
    if got != want:
        raise AssertionError(f"[{tag} dense] the dense step launched {got}, "
                             f"expected {want}")
    out["ell_vs_dense"] = hold_step(f"{tag} dense", "dense", k_step, d_step)
    log(f"[{tag}] ell step vs dense step: " + ", ".join(
        f"{k} {v:.6e}" for k, v in out["ell_vs_dense"].items()))
    del dense
    if model_name == "DiffNet":
        for impl, want in (("pallas", {"segment_spmm": n,
                                       "segment_spmm_transpose": n}),
                           ("xla", {"row_gather": 2 * n,
                                    "block_segment_sum": 2 * n})):
            _, _, m = social_model(tmp, model_name, dev, impl)
            out[f"{impl}_vs_plain"] = general_step_vs_plain(
                m, params, extras, batch, mode, want, f"{tag} {impl}")
            log(f"[{tag}] {impl} step vs plain: " + ", ".join(
                f"{k} {v:.6e}" for k, v in out[f"{impl}_vs_plain"].items()))
    return out


def social_serve(run: dict, tmp: str, dev) -> dict:
    """Export MHCN from its checkpoint and serve it by ``RecServer``,
    every counter set to 0 just before and read just after (the export
    propagates once: 10 K2; serving launches none); the exported tables
    against a propagation on the plain SpMMs in float64 (an f32 one sums
    with CUDA atomics in an order that changes from run to run, which
    put one entry near 0 of 121,152 past the tolerance in one run of
    the same code), the served top-k against those plain tables (float64
    on the host), ``recommend`` latency and one HTTP round trip."""
    import importlib
    from recbole_gnn_tpu_torch.ops.segment_spmm import spmm_coo
    from recbole_gnn_tpu_torch.serve import RecServer, export_artifact
    from recbole_gnn_tpu_torch.train.optim import tree_map
    spmm_mod = importlib.import_module("recbole_gnn_tpu_torch.ops.spmm")
    tag = "MHCN social serve"
    art = os.path.join(tmp, "mhcn-social.npz")
    reset_counts()
    t0 = time.perf_counter()
    export_artifact(run["config"], art, checkpoint_path=run["ckpt"],
                    device=dev)
    export_s = time.perf_counter() - t0
    export_counts = read_counts()
    kernel_spmm = spmm_mod.spmm
    spmm_mod.spmm = lambda g, x, weight_grad=False: spmm_coo(
        g.src, g.dst, g.weight, x, g.n_nodes)
    f64 = (lambda t: t.double() if isinstance(t, torch.Tensor)
           and torch.is_floating_point(t) else t)
    try:
        with torch.inference_mode():
            u, i = run["model"].propagate(tree_map(f64, run["params"]),
                                          run["model"].consts,
                                          tree_map(f64, run["extras"] or {}))
    finally:
        spmm_mod.spmm = kernel_spmm
    plain = (u.cpu().numpy(), i.cpu().numpy())
    with np.load(art, allow_pickle=False) as z:
        for got, want in zip((z["user_table"], z["item_table"]), plain):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        table_err = max(float(np.abs(z["user_table"] - plain[0]).max()),
                        float(np.abs(z["item_table"] - plain[1]).max()))
    reset_counts()
    srv = RecServer(art, device=dev)
    rng = np.random.default_rng(SEED)
    latency = {}
    for b in (1, 64, 1024):
        uids = rng.choice(np.arange(1, srv.n_users), b, replace=False)
        toks = [str(srv.user_tokens[u]) for u in uids]
        srv.recommend(toks, k=TOP_K)          # warm-up
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            idx, vals = srv.recommend(toks, k=TOP_K, return_tokens=False)
            times.append(time.perf_counter() - t0)
        latency[b] = float(np.median(times)) * 1e3
        check_recommendations(srv, uids, idx, vals, plain)
    out = http_roundtrip(srv, [str(t) for t in srv.user_tokens[1:4]], TOP_K)
    if len(out["items"]) != 3:
        raise AssertionError(f"[{tag}] the HTTP answer: {out}")
    counts = read_counts()
    want = {k: (SOCIAL_EVAL_SPMMS["MHCN"] if k == "ell_spmm" else 0)
            for k in counts}
    if export_counts != want or any(counts.values()):
        raise AssertionError(f"[{tag}] the export launched {export_counts} "
                             f"(expected {want}), serving {counts}")
    log(f"[{tag}] export {export_s:.2f} s, launches {export_counts}; "
        f"exported tables vs the plain propagation max |err| "
        f"{table_err:.3e}; served top-{TOP_K} equal to the plain tables' "
        f"for B = 1, 64, 1024; recommend latency (ms, median of 5): "
        + ", ".join(f"B={b}: {ms:.2f}" for b, ms in latency.items()))
    return {"counts": export_counts, "export_s": export_s,
            "latency_ms": latency, "table_max_abs_err": table_err}


def social_main(tmp: str, out_path: str) -> int:
    """The social phase (a child process of :func:`main`): writes the
    LastFM-shape log into ``tmp``, trains DiffNet, MHCN and SEPT on
    ``ell``, holds their steps against the plain and dense steps (and
    DiffNet's on ``pallas`` and ``xla``), serves MHCN; writes the launch
    counts by path and the summaries to ``out_path``."""
    from recbole_gnn_tpu_torch.diag.lastfm_shape import (
        LASTFM_SHAPE, shared_artist_share, write_lastfm_shape)
    from recbole_gnn_tpu_torch.ops import cuda_build
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cuda_build.build(SOURCES)              # built by main: loads only
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    inter, net = write_lastfm_shape(tmp, "lastfm_shape", SEED,
                                    **LASTFM_SHAPE)
    log(f"[social data] LastFM-shape log written "
        f"({time.perf_counter() - t0:.1f} s): {LASTFM_SHAPE}; friend pairs "
        f"sharing an artist {shared_artist_share(inter, net):.4f}")
    paths, summary, steps = {}, {}, {}
    lap = lap_timer()
    for name in SOCIAL_MODELS:
        run = social_path(tmp, name, dev)
        paths[f"{name.lower()}_social_ell_train"] = run["counts"]
        summary[name] = run["summary"]
        steps[name] = social_steps(tmp, run, name, dev)
        lap(f"[{name} social ell] path and steps")
        if name == "DiffNet":
            # DiffNet on the other impls' kernels: K1, then D2 + D1
            for impl in ("pallas", "xla"):
                other = social_path(tmp, name, dev, impl)
                paths[f"diffnet_social_{impl}_train"] = other["counts"]
                summary[f"DiffNet {impl}"] = other["summary"]
                del other
                lap(f"[DiffNet social {impl}] path")
        if name == "MHCN":
            serving = social_serve(run, tmp, dev)
            paths["mhcn_social_serve"] = serving["counts"]
            lap("[MHCN social serve] path")
        del run
        torch.cuda.empty_cache()
    log(json.dumps({"social_models": summary, "social_steps": steps,
                    "social_serving": serving, "card": card}))
    with open(out_path, "w") as f:
        json.dump({"paths": paths, "summary": summary, "steps": steps,
                   "serving": serving, "card": card}, f)
    return 0


def run_social_phase(tmp: str) -> dict:
    """Run :func:`social_main` in a child process; its output goes to
    this process's; a failure there fails here."""
    out_path = os.path.join(tmp, "social_phase.json")
    t0 = time.perf_counter()
    sys.stdout.flush()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--social", tmp, out_path])
    if r.returncode != 0:
        raise AssertionError(f"the social phase failed (exit "
                             f"{r.returncode})")
    log(f"social phase: {time.perf_counter() - t0:.1f} s")
    with open(out_path) as f:
        return json.load(f)

# -- the parallel paths ----------------------------------------------------

PARALLEL_MESH = {"dp": 2, "tp": 2}
PARALLEL_RANKS = 4                 # gloo ranks that share the one card
PARALLEL_SHARDS = 4                # edge shards run in one process
PARALLEL_STEPS = 10                # steps of each gloo-rank fit
# K7b alone: a validation batch's users and history width
PARALLEL_TOPK_USERS = 4096
PARALLEL_TOPK_HISTORY = 64
# the gloo ranks' fit against the single-process fit, both on the card
# from one checkpoint: the same sums in another order (edge shards,
# all-reduced partials) through PARALLEL_STEPS Adam steps, the tolerance
# the CPU tests hold the mesh fit to; test metrics abs 1e-3 (a rank can
# flip on a near-tie)
PARALLEL_PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
PARALLEL_METRIC_ATOL = 1e-3


def parallel_config(tmp: str, name: str, **over) -> dict:
    """The ell path's config (LightGCN, 64 wide, 3 layers) in a
    checkpoint directory of its own, with ``over``; no jsonl."""
    cd = train_config(tmp, "ell")
    ck = os.path.join(tmp, f"LightGCN-parallel-{name}")
    cd.update(checkpoint_dir=ck, **over)
    del cd["metrics_log_path"]
    return cd


def share_dataset_cache(src_ck: str, dst_ck: str) -> None:
    """Copy the dataset cache of one checkpoint directory into another
    (the cache key is the same: only the mesh and graph keys differ)."""
    import shutil
    os.makedirs(dst_ck, exist_ok=True)
    for f in os.listdir(src_ck):
        if f.endswith("Dataset.pth"):
            shutil.copy(os.path.join(src_ck, f), dst_ck)


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def hold_metrics(tag: str, got: dict, want: dict, atol: float) -> float:
    if got.keys() != want.keys() or not got:
        raise AssertionError(f"[{tag}] metrics {got} against {want}")
    worst = max(abs(got[k] - want[k]) for k in want)
    if not worst <= atol:
        raise AssertionError(f"[{tag}] metrics differ by {worst:.3e} "
                             f"(> {atol}): {got} against {want}")
    return worst


def hold_params(tag: str, got: dict, want: dict, tol: dict) -> float:
    worst = 0.0
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        err = np.abs(a - b)
        if a.shape != b.shape or not np.all(err <= tol["atol"]
                                            + tol["rtol"] * np.abs(b)):
            raise AssertionError(f"[{tag}] {k} differs: shapes {a.shape} "
                                 f"{b.shape}, max |err| {err.max():.3e}")
        worst = max(worst, float(err.max()))
    return worst


def parallel_shards(graph, dev) -> dict:
    """(iii) Every shard of the edge-sharded K2/K2ᵀ in this process at
    the slice shape: the shards' forward blocks against unsharded K2,
    the sum of their transpose shares against unsharded K2ᵀ, within
    TOL_REL_ABSSUM; each shard's edges."""
    from recbole_gnn_tpu_torch.ops.ell_spmm import (ell_spmm,
                                                    ell_spmm_transpose)
    from recbole_gnn_tpu_torch.ops.segment_spmm import spmm_coo
    from recbole_gnn_tpu_torch.parallel.sharded_spmm import (
        build_sharded_ell, shard_forward, shard_transpose)
    nnz, n = graph.nnz, graph.n_nodes
    src, dst = graph.src[:nnz].cpu().numpy(), graph.dst[:nnz].cpu().numpy()
    t0 = time.perf_counter()
    meta = build_sharded_ell(src, dst, graph.weight[:nnz].cpu().numpy(), n,
                             PARALLEL_SHARDS, device=dev)
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    x = torch.randn(n, EMBEDDING_SIZE, device=dev, generator=gen)
    cot = torch.randn(n, EMBEDDING_SIZE, device=dev, generator=gen)
    blk = meta.node_block
    full = cot.new_zeros((blk * PARALLEL_SHARDS, EMBEDDING_SIZE))
    full[:n] = cot
    shards = [meta.shards[i] for i in range(PARALLEL_SHARDS)]
    with torch.inference_mode():
        reset_counts()
        out = torch.cat([shard_forward(sh, x) for sh in shards])[:n]
        grad = sum(shard_transpose(sh, full[i * blk:(i + 1) * blk])
                   for i, sh in enumerate(shards))
        counts = read_counts()
        fwd_err = hold("K2 (edge shards)", "slice", out,
                       ell_spmm(graph.ell, x),
                       spmm_coo(graph.src, graph.dst, graph.weight.abs(),
                                x.abs(), n))
        rev_err = hold("K2T (edge shards)", "slice", grad,
                       ell_spmm_transpose(graph.rev_ell, cot),
                       spmm_coo(graph.rev_src, graph.rev_dst,
                                graph.rev_weight.abs(), cot.abs(),
                                graph.n_src_nodes))
        per = [{"edges": sh.n_edges,
                "dst_rows": [i * blk, min((i + 1) * blk, n)],
                "split_nodes": sh.fwd.n_multi}
               for i, sh in enumerate(shards)]
    edges = [p["edges"] for p in per]
    if sum(edges) != nnz:
        raise AssertionError(f"the shards hold {sum(edges)} edges, the "
                             f"graph {nnz}")
    want = {k: 0 for k in counters()}
    want.update(ell_spmm=PARALLEL_SHARDS, ell_spmm_transpose=PARALLEL_SHARDS)
    imbalance = max(edges) / (sum(edges) / PARALLEL_SHARDS)
    log(f"[parallel shards] {PARALLEL_SHARDS} dst blocks of {blk} nodes "
        f"over {nnz} edges (host build {build_s:.2f} s): edges "
        f"{edges}, imbalance (max/mean) {imbalance:.3f}; summed shards "
        "against unsharded K2 "
        f"max_abs_err {fwd_err:.3e}, K2T {rev_err:.3e}")
    return {"shards": per, "imbalance": imbalance,
            "max_abs_err": fwd_err, "max_abs_err_t": rev_err,
            "build_s": build_s, "counts": counts, "want": want}


def topk_alone(n_items: int, dev) -> dict:
    """K7b (``distributed_full_sort_topk``) alone, on a group of one, at
    the gloo ranks' validation shape: a batch of PARALLEL_TOPK_USERS
    users against a tp = 2 block of the catalog (⌈n_items / 2⌉ rows),
    k = TOP_K, each user's PARALLEL_TOPK_HISTORY history ids masked;
    its top-k values against its plain form's (the masked (B, I) scores
    and one ``torch.topk``)."""
    from recbole_gnn_tpu_torch.parallel.topk import distributed_full_sort_topk
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    b, h, d = PARALLEL_TOPK_USERS, PARALLEL_TOPK_HISTORY, EMBEDDING_SIZE
    rows = -(-n_items // 2)
    u = torch.randn(b, d, device=dev, generator=gen)
    items = torch.randn(rows, d, device=dev, generator=gen)
    hist = torch.randint(0, rows, (b, h), device=dev, generator=gen)

    def plain():
        scores = u @ items.T
        scores.scatter_(1, hist, float("-inf"))
        return torch.topk(scores, TOP_K, dim=1)

    got = distributed_full_sort_topk(u, items, hist, TOP_K, None)
    want = plain()
    if not torch.equal(got[0], want.values):
        raise AssertionError("K7b alone: top-k values differ from the "
                             "plain form's")
    same = got[0] == want.values  # equal infinities subtract to NaN
    err = float(torch.where(same, 0.0, (got[0] - want.values).abs()).max())
    out = {"users": b, "item_rows": rows, "k": TOP_K, "max_abs_err": err}
    log(f"[parallel K7b alone] {json.dumps(out)}")
    return out


def parallel_rank_main(rank: int, tmp: str, port: int, out_dir: str
                       ) -> int:
    """(ii) One of PARALLEL_RANKS gloo ranks that share the card: a
    ``{dp: 2, tp: 2}`` LightGCN fit of PARALLEL_STEPS steps on the
    edge-sharded ell graph from the shared initial checkpoint, then a
    validation pass; writes its counts (rank 0: also the params and
    metrics) to ``out_dir``."""
    import torch.distributed as dist
    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.models import get_model
    from recbole_gnn_tpu_torch.parallel.launch import init_distributed
    from recbole_gnn_tpu_torch.quick_start import (create_dataset,
                                                   data_preparation)
    from recbole_gnn_tpu_torch.train.trainer import Trainer
    init_distributed(f"127.0.0.1:{port}", PARALLEL_RANKS, rank,
                     backend="gloo")
    dev = torch.device("cuda")
    cd = parallel_config(tmp, "gloo", mesh_shape=PARALLEL_MESH,
                         graph_edge_sharding=True)
    config = Config(model="LightGCN", dataset="gowalla_shape",
                    config_dict=cd)
    with capped_train_steps(PARALLEL_STEPS):
        (tl, tr), (vl, _), _ = data_preparation(config,
                                                create_dataset(config))
    model = get_model("LightGCN")(config, tr, dev)
    trainer = Trainer(config, model)
    trainer.resume_from_checkpoint(os.path.join(tmp, "parallel_init.ckpt"))
    reset_counts()
    t0 = time.perf_counter()
    trainer.fit(tl, None, saved=False, verbose=False)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = trainer.evaluate(vl, load_best_model=False)
    eval_s = time.perf_counter() - t0
    out = {"rank": rank, "counts": read_counts(), "fit_s": fit_s,
           "eval_s": eval_s, "metrics": metrics,
           "graph": type(model.consts["graph"]).__name__,
           "shard_edges": model.consts["graph"].local.n_edges,
           "backend": dist.get_backend(), "device": str(
               trainer.params["user_emb"].device),
           "plan": trainer._pad_plan}
    if rank == 0:
        np.savez(os.path.join(out_dir, "params.npz"), **{
            k: v.cpu().numpy() for k, v in trainer.params.items()})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def parallel_main(tmp: str, out_path: str) -> int:
    """The parallel phase (a child process of :func:`main`, or alone on
    its own data): (iii) every edge shard of K2/K2ᵀ in this process;
    (i) ``run --distributed`` on NCCL at world size 1 against the same
    run without it; (ii) PARALLEL_RANKS gloo ranks sharing the card,
    dp × tp with the edge-sharded graph, against the single-process
    fit.  Writes the launch counts by path and the summary to
    ``out_path``."""
    import recbole_gnn_tpu_torch.run as run_cli
    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.diag.gowalla_shape import (
        GOWALLA_SHAPE, write_gowalla_shape)
    from recbole_gnn_tpu_torch.models import get_model
    from recbole_gnn_tpu_torch.ops import cuda_build
    from recbole_gnn_tpu_torch.quick_start import (create_dataset,
                                                   data_preparation,
                                                   run_recbole_gnn_tpu)
    from recbole_gnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                       save_checkpoint)
    from recbole_gnn_tpu_torch.train.trainer import Trainer
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cuda_build.build(SOURCES)              # built by main: loads only
    if not os.path.isdir(os.path.join(tmp, "gowalla_shape")):
        write_gowalla_shape(tmp, "gowalla_shape", SEED, **GOWALLA_SHAPE)
    paths, summary = {}, {}

    # the non-distributed ell run (the reference of (i)); its model's
    # graph serves (iii)
    cd = parallel_config(tmp, "single")
    if os.path.isdir(train_config(tmp, "ell")["checkpoint_dir"]):
        share_dataset_cache(train_config(tmp, "ell")["checkpoint_dir"],
                            cd["checkpoint_dir"])
    reset_counts()
    t0 = time.perf_counter()
    single = run_recbole_gnn_tpu(model="LightGCN", dataset="gowalla_shape",
                                 config_dict=cd, saved=True, verbose=False)
    paths["parallel_single_train"] = read_counts()
    summary["single_run_s"] = time.perf_counter() - t0
    single_steps = summary["single_steps"] = read_steps()
    config = Config(model="LightGCN", dataset="gowalla_shape",
                    config_dict=cd)
    with capped_train_steps(PARALLEL_STEPS):
        (tl, tr), (vl, _), _ = data_preparation(config,
                                                create_dataset(config))
    model = get_model("LightGCN")(config, tr, dev)

    # (iii) the edge shards in this process
    shards = parallel_shards(model.consts["graph"], dev)
    if shards["counts"] != shards["want"]:
        raise AssertionError(f"[parallel shards] launches "
                             f"{shards['counts']}, expected "
                             f"{shards['want']}")
    paths["parallel_shards"] = shards.pop("counts")
    shards.pop("want")
    summary["shards"] = shards
    summary["topk_alone"] = topk_alone(model.n_items, dev)

    # (i) run --distributed: NCCL, world size 1, the edge-sharded graph
    ck = parallel_config(tmp, "nccl")["checkpoint_dir"]
    share_dataset_cache(cd["checkpoint_dir"], ck)
    argv = ["--distributed", "-m", "LightGCN", "-d", "gowalla_shape",
            "--mesh_shape=[1]", "--graph_edge_sharding=True"] + [
        f"--{k}={v}" for k, v in parallel_config(tmp, "nccl").items()]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    reset_counts()
    t0 = time.perf_counter()
    nccl = run_cli.main(argv)
    paths["parallel_nccl_train"] = read_counts()
    summary["nccl_run_s"] = time.perf_counter() - t0
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK"):
        del os.environ[k]

    def rest(counts: dict, issued: int) -> dict:
        # the launches less N_LAYERS K2 and K2T for each step whose
        # kernels went through the wrappers: the evaluations' K2
        out = dict(counts)
        for k in ("ell_spmm", "ell_spmm_transpose"):
            out[k] -= N_LAYERS * issued
        return out
    # --distributed runs the mesh's sharded step, never captured (and
    # outside ``train_step``'s counters): each of the run's steps, as
    # many as the single run's, launches through the wrappers
    nccl_rest = rest(paths["parallel_nccl_train"], single_steps["steps"])
    if (nccl_rest != rest(paths["parallel_single_train"],
                          single_steps["issued"])
            or nccl_rest["ell_spmm_transpose"]):
        raise AssertionError(
            f"[parallel nccl] launches {paths['parallel_nccl_train']} "
            f"({single_steps['steps']} eager steps) against the run "
            f"without --distributed {paths['parallel_single_train']} "
            f"({single_steps})")
    worst_i = hold_metrics("parallel nccl", nccl["test_result"],
                           single["test_result"], PARALLEL_METRIC_ATOL)
    ckpt = "LightGCN-gowalla_shape.ckpt"
    p_err_i = hold_params(
        "parallel nccl", load_checkpoint(os.path.join(ck, ckpt))["params"],
        load_checkpoint(os.path.join(cd["checkpoint_dir"], ckpt))["params"],
        PARALLEL_PARAM_TOL)
    summary["nccl"] = {"test": nccl["test_result"],
                       "single_test": single["test_result"],
                       "metric_max_abs_diff": worst_i,
                       "param_max_abs_err": p_err_i}
    log(f"[parallel nccl] run --distributed --mesh_shape=[1] on NCCL, world "
        f"size 1, edge-sharded ell: test {nccl['test_result']} against "
        f"{single['test_result']} without it (max |diff| {worst_i:.3e}); "
        f"params max |err| {p_err_i:.3e}; launches "
        f"{paths['parallel_nccl_train']} ({summary['nccl_run_s']:.1f} s, "
        f"the run without it {summary['single_run_s']:.1f} s)")

    # (ii) four gloo ranks on the card against the single-process fit
    init = os.path.join(tmp, "parallel_init.ckpt")
    params = model.init_params(torch.Generator().manual_seed(SEED))
    trainer = Trainer(config, model)
    save_checkpoint(init, {
        "params": params, "opt_state": trainer.optimizer.init(params),
        "extras": {}, "epoch": np.int64(-1),
        "best_score": np.float64(np.nan), "best_epoch": np.int64(-1),
        "config": {"model": "LightGCN", "dataset": "gowalla_shape"}})
    trainer.resume_from_checkpoint(init)
    reset_counts()
    trainer.fit(tl, None, saved=False, verbose=False)
    want_metrics = trainer.evaluate(vl, load_best_model=False)
    paths["parallel_single_fit"] = read_counts()
    want_params = {k: v.cpu().numpy() for k, v in trainer.params.items()}
    share_dataset_cache(cd["checkpoint_dir"],
                        parallel_config(tmp, "gloo")["checkpoint_dir"])
    out_dir = os.path.join(tmp, "parallel_ranks")
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    t0 = time.perf_counter()
    sys.stdout.flush()
    # the host's cores shared out between the ranks
    env = dict(os.environ, OMP_NUM_THREADS=str(max(
        1, (os.cpu_count() or PARALLEL_RANKS) // PARALLEL_RANKS)))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--parallel-rank", str(r), tmp, str(port),
                               out_dir], env=env)
             for r in range(PARALLEL_RANKS)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    ranks_s = time.perf_counter() - t0
    if any(rcs):
        raise AssertionError(f"[parallel gloo] rank exit codes {rcs}")
    ranks = []
    for r in range(PARALLEL_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    n_steps = len(tl)
    want = {k: 0 for k in counters()}
    # K7b: the item-sharded full sort over tp, once per scored chunk of
    # each validation batch, the same on every rank
    topk_calls = ranks[0]["counts"]["distributed_full_sort_topk"]
    if topk_calls < 1:
        raise AssertionError("[parallel gloo] validation never ran K7b")
    want.update(ell_spmm=N_LAYERS * (n_steps + 1),
                ell_spmm_transpose=N_LAYERS * n_steps,
                distributed_full_sort_topk=topk_calls)
    for r in ranks:
        if (r["counts"] != want or r["graph"] != "ShardedEll"
                or r["backend"] != "gloo" or r["device"] != "cuda:0"):
            raise AssertionError(f"[parallel gloo] rank {r['rank']}: "
                                 f"{r}; expected launches {want}")
    got = dict(np.load(os.path.join(out_dir, "params.npz")))
    p_err = hold_params("parallel gloo", got, want_params,
                        PARALLEL_PARAM_TOL)
    m_err = max(hold_metrics(f"parallel gloo rank {r['rank']}",
                             r["metrics"], want_metrics,
                             PARALLEL_METRIC_ATOL) for r in ranks)
    paths["parallel_gloo_train"] = {k: sum(r["counts"][k] for r in ranks)
                                    for k in want}
    summary["gloo"] = {"ranks_s": ranks_s, "steps": n_steps,
                       "fit_s": [r["fit_s"] for r in ranks],
                       "eval_s": [r["eval_s"] for r in ranks],
                       "shard_edges": [r["shard_edges"] for r in ranks],
                       "plan": ranks[0]["plan"], "metrics": ranks[0]["metrics"],
                       "single_metrics": want_metrics,
                       "param_max_abs_err": p_err,
                       "metric_max_abs_diff": m_err}
    log(f"[parallel gloo] {PARALLEL_RANKS} gloo ranks on {ranks[0]['device']}"
        f", mesh {PARALLEL_MESH}, edge-sharded ell over dp (shard edges "
        f"{summary['gloo']['shard_edges']}), pad plan "
        f"{ranks[0]['plan']}: {n_steps} steps in "
        f"{[round(r['fit_s'], 2) for r in ranks]} s, validation "
        f"{[round(r['eval_s'], 2) for r in ranks]} s ({ranks_s:.1f} s with "
        f"start-up); params max |err| {p_err:.3e} against the "
        f"single-process fit, metrics max |diff| {m_err:.3e} "
        f"({ranks[0]['metrics']} against {want_metrics}); launches per "
        f"rank {want}")
    summary["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"parallel": summary}))
    with open(out_path, "w") as f:
        json.dump({"paths": paths, "summary": summary}, f)
    return 0


def run_parallel_phase(tmp: str) -> dict:
    """Run :func:`parallel_main` in a child process; its output goes to
    this process's; a failure there fails here."""
    out_path = os.path.join(tmp, "parallel_phase.json")
    t0 = time.perf_counter()
    sys.stdout.flush()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--parallel", tmp, out_path])
    if r.returncode != 0:
        raise AssertionError(f"the parallel phase failed (exit "
                             f"{r.returncode})")
    log(f"parallel phase: {time.perf_counter() - t0:.1f} s")
    with open(out_path) as f:
        return json.load(f)


# -- main -------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from recbole_gnn_tpu_torch.diag import pallas_floor
    from recbole_gnn_tpu_torch.diag import row_gather as d2
    from recbole_gnn_tpu_torch.diag.gowalla_shape import (
        GOWALLA_SHAPE, write_gowalla_shape)
    from recbole_gnn_tpu_torch.ops import cuda_build
    from recbole_gnn_tpu_torch.ops.ell_spmm import ell_spmm, ell_spmm_transpose
    from recbole_gnn_tpu_torch.ops.gather import row_gather
    from recbole_gnn_tpu_torch.ops.segment_spmm import (
        PRECISIONS, SHARE_EDGES, segment_spmm, segment_spmm_transpose)
    from recbole_gnn_tpu_torch.ops.segment_sum import (
        SHARE_EDGES as D1_SHARE_EDGES, block_segment_sum)
    from recbole_gnn_tpu_torch.ops.spmm import build_graph

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 U·Iᵀ
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t_main = time.perf_counter()
    for cut in DEPTH_CUTS:
        log(f"depth cut: {cut}")
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
    # registers and spills of every kernel of the build, one line each
    for name, text in build_log.items():
        for entry in cuda_build.ptxas_usage(text):
            log(f"  ptxas {name}: {json.dumps(entry)}")

    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 3. the slice's data
        t0 = time.perf_counter()
        write_gowalla_shape(tmp, "gowalla_shape", SEED, **GOWALLA_SHAPE)
        log(f"data written ({time.perf_counter() - t0:.1f} s)")

        # 4. the paths, each with the counters at 0 before it: the
        # default impl first
        lap = lap_timer()
        ell = train_path(tmp, "ell", dev)
        paths["ell_train"] = ell["counts"]
        lap("[ell] train path")
        paths["ell_serve"] = serve_path(ell, tmp, "ell", dev)
        lap("[ell] serve path")
        with capped_train_steps(FAMILY_TRAIN_STEPS):
            pallas = train_path(tmp, "pallas", dev)
        paths["pallas_train"] = pallas["counts"]
        lap("[pallas] train path")
        paths["pallas_serve"] = serve_path(pallas, tmp, "pallas", dev,
                                           batches=(1, 64))
        lap("[pallas] serve path")
        with capped_train_steps(FAMILY_TRAIN_STEPS):
            xla = train_path(tmp, "xla", dev)
        paths["xla_train"] = xla["counts"]
        lap("[xla] train path")
        paths["xla_serve"] = serve_path(xla, tmp, "xla", dev,
                                        batches=(1, 64))
        lap("[xla] serve path")
        for model_name in ("SimGCL", "XSimGCL"):
            with capped_train_steps(FAMILY_TRAIN_STEPS):
                run = train_path(tmp, "ell", dev, model_name)
            paths[f"{model_name.lower()}_train"] = run["counts"]
            del run
            lap(f"[{model_name} ell] train path")
        reset_counts()
        probe1 = pallas_floor.run("cuda")
        probe2 = d2.run("cuda")
        paths["probes"] = read_counts()
        lap("probes")
        for name, r in (("D1 block_segment_sum", probe1),
                        ("D2 row_gather", probe2)):
            log(f"probe {name} at the TPU probe's shape: "
                f"{json.dumps(r)}")
        graph, params = pallas["graph"], pallas["params"]

        # 5. every kernel against its plain version: the slice shape,
        # then the edge cases
        with torch.inference_mode():
            gen = torch.Generator(device=dev).manual_seed(SEED)
            x = torch.cat([params["user_emb"], params["item_emb"]]).contiguous()
            cot = torch.randn(graph.n_nodes, EMBEDDING_SIZE, device=dev,
                              generator=gen)
            max_err, max_err_t = check_kernels("slice", graph, x, cot)
            xla_err = check_xla_kernels("slice", graph, x, cot)
            mode_err = check_k1_modes("slice", graph, x, cot)
            # K2 on the ell run's graph and trained params
            eg = ell["graph"]
            xe = torch.cat([ell["params"]["user_emb"],
                            ell["params"]["item_emb"]]).contiguous()
            k2_err, k2_err_t = check_ell("slice", eg, xe, cot)
            # every kernel in its bf16-x mode (activation_dtype: bfloat16)
            bf16_err = check_bf16_kernels("slice", graph, eg, xe, cot)
            # the share passes and the carry passes sum in a fixed order
            raw = row_gather(x, graph.src)      # D1's input on the xla path
            for kind, rerun in (
                    ("K1", lambda: segment_spmm(
                        graph.src, graph.dst, graph.weight, graph.rowptr,
                        x)),
                    ("K1T", lambda: segment_spmm_transpose(
                        graph.rev_src, graph.rev_dst, graph.rev_weight,
                        graph.rev_rowptr, cot)),
                    ("D1", lambda: block_segment_sum(
                        raw, graph.dst, graph.rowptr, "f32",
                        weight=graph.weight)),
                    ("D1 bf16x", lambda: block_segment_sum(
                        raw.to(torch.bfloat16), graph.dst, graph.rowptr,
                        "f32", weight=graph.weight))) + tuple(
                    (f"K1 {p} {dt}", lambda p=p, dt=dt: segment_spmm(
                        graph.src, graph.dst, graph.weight, graph.rowptr,
                        x.to(dt), p))
                    for p in PRECISIONS
                    for dt in (torch.float32, torch.bfloat16)) + tuple(
                    (f"K1T {p}", lambda p=p: segment_spmm_transpose(
                        graph.rev_src, graph.rev_dst, graph.rev_weight,
                        graph.rev_rowptr, cot, p)) for p in K1_MODES):
                if not torch.equal(rerun(), rerun()):
                    raise AssertionError(f"{kind} reruns at the slice shape "
                                         "differ")
            lap("kernel checks at the slice shape")
            log("determinism: two launches each of K1 in every precision "
                "on f32 and bf16 x, K1T in every precision, D1 (f32 and "
                "bf16x, weighted) at the slice shape equal bit for bit (K2, "
                "K2T: check_ell; the edge cases: check_bf16_kernels)")
            case_rng = np.random.default_rng(SEED + 1)
            for name, s, d_, w, n_dst, n_src, dim in edge_case_graphs(case_rng):
                g = build_graph(s, d_, w, n_dst, n_src, device=dev,
                                with_pallas=True, with_reverse=True,
                                impl="ell")
                xc = torch.from_numpy(case_rng.normal(
                    size=(n_src, dim)).astype(np.float32)).to(dev)
                gc = torch.from_numpy(case_rng.normal(
                    size=(n_dst, dim)).astype(np.float32)).to(dev)
                # K1's and D1's share sizes
                for t in (sorted({SHARE_EDGES, D1_SHARE_EDGES})
                          if name == "share_boundaries" else ()):
                    ends, empties = boundary_rows(g.rowptr, t)
                    log(f"share_boundaries at T={t}: {ends} rows end on a "
                        f"share boundary, {empties} empty rows sit on one")
                    if not (ends and empties):
                        raise AssertionError("share_boundaries holds no row "
                                             "on a share boundary")
                sizes = (SHARE_CHECKED if len(s) <= SMALL_CASE_EDGES
                         else (None,))
                check_kernels(name, g, xc, gc, sizes)
                errs = check_xla_kernels(name, g, xc, gc, share_sizes=sizes)
                e2 = check_ell(name, g, xc, gc)
                k2_err, k2_err_t = max(k2_err, e2[0]), max(k2_err_t, e2[1])
                for p, v in check_k1_modes(name, g, xc, gc, sizes).items():
                    mode_err[p] = max(mode_err[p], v)
                merge_errs(bf16_err, check_bf16_kernels(name, g, g, xc, gc,
                                                        sizes))
                if name in ("hub_rows", "rectangular", "multi_segment"):
                    errs = check_xla_kernels(f"{name} chunk={CHUNK}", g, xc,
                                             gc, chunk=CHUNK)
                for k, v in errs.items():
                    xla_err[k] = max(xla_err[k], v)
                del g, xc, gc
                lap(f"kernel checks on {name}")
            e2 = check_ell_cases(case_rng, dev)
            k2_err, k2_err_t = max(k2_err, e2[0]), max(k2_err_t, e2[1])
            lap("K2's non-finite and zero-weight cases")
            log("max_abs_err against the plain versions (slice and edge "
                "cases; K1, K1T at the slice): " + json.dumps(
                    {"K1": max_err, "K1T": max_err_t, "K1 modes": mode_err,
                     "K2": k2_err, "K2T": k2_err_t, **xla_err,
                     "bf16x": bf16_err}))

            # 6. one call of each two-pass kernel at the slice shape runs
            # exactly its two device kernels: K1, K1T and D1 the share
            # pass and the carry pass, K2 and K2T the row pass and the
            # combine pass (the slice has split nodes, the hub, and
            # isolated ones)
            per_call = {}
            for kind, fn in (
                    ("K1", lambda: segment_spmm(
                        graph.src, graph.dst, graph.weight, graph.rowptr,
                        x)),
                    ("K1T", lambda: segment_spmm_transpose(
                        graph.rev_src, graph.rev_dst, graph.rev_weight,
                        graph.rev_rowptr, cot)),
                    ("K2", lambda: ell_spmm(eg.ell, xe)),
                    ("K2T", lambda: ell_spmm_transpose(eg.rev_ell, cot)),
                    ("D1", lambda: block_segment_sum(
                        raw, graph.dst, graph.rowptr, "f32",
                        weight=graph.weight))):
                per_call[kind] = device_kernels(fn)
                if len(per_call[kind]) != 2:
                    raise AssertionError(
                        f"the profiler saw {per_call[kind]} per {kind} "
                        "call; expected 2 device kernels")
            log("device kernels per call at the slice shape "
                f"(torch.profiler): {json.dumps(per_call)}")
        lap("device kernels per call")
        # the InfoNCE pair against its plain version (autograd: outside
        # inference mode)
        nce_err = check_nce(dev)
        log("max error of the InfoNCE pair against its float64 plain "
            f"version (lse abs; dv1, dav2 rel): {json.dumps(nce_err)}")
        lap("InfoNCE pair checks")

        # 7. the general family on ell, each at its published settings,
        # in a process of its own
        log(f"main paths, probes and kernel checks: "
            f"{time.perf_counter() - t_main:.1f} s")
        general = run_general_phase(tmp)
        paths.update(general["paths"])
        # 8. the session family, in a process of its own
        session = run_session_phase(tmp)
        paths.update(session["paths"])
        # 9. the social family, in a process of its own
        social = run_social_phase(tmp)
        paths.update(social["paths"])
        # 10. the parallel paths, last, in a process of its own
        parallel = run_parallel_phase(tmp)
        paths.update(parallel["paths"])
    log(f"launches by path: {json.dumps(paths)}")
    log(f"chip_smoke: {time.perf_counter() - t_main:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--general":
        sys.exit(general_main(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == "--session":
        sys.exit(session_main(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == "--social":
        sys.exit(social_main(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == "--parallel":
        sys.exit(parallel_main(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 6 and sys.argv[1] == "--parallel-rank":
        sys.exit(parallel_rank_main(int(sys.argv[2]), sys.argv[3],
                                    int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
