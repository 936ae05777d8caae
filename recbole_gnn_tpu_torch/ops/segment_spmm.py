"""Segment SpMM over dst-sorted edges — the port's CUDA kernel.

Counterpart of ``recbole_gnn_tpu/ops/pallas_spmm.py``.  Both compute

    out[d] = Σ_{e: dst[e]=d} w[e] · x[src[e]]

over an edge list sorted by destination and padded with weight-0
edges.  The Pallas kernel streamed a materialised message array in
≤ 2²⁰-edge segments through one-hot MXU products; the Hopper kernel
(``csrc/segment_spmm.cu``) gathers ``x[src]`` itself over equal edge
shares of ``SHARE_EDGES`` edges, whatever rows they fall in, driven by
a CSR row pointer built here on the host (the counterpart of
``build_pallas_meta``).  A row that crosses a share boundary is summed
from per-share carries in share order by a second pass.
:func:`share_schedule` is that arithmetic in torch,
:func:`share_sum_plain` sums messages in edge order by it (D1,
``ops/segment_sum.py``, runs the same schedule) and
:func:`segment_spmm_shares_plain` computes the SpMM by it; the tests
and ``chip_smoke.py`` use them to check the kernels' schedule.

The host padding (``segment_layout``/``pad_edges``) is a copy of the
JAX package's, so a padded ``Graph`` holds the same arrays element for
element in both packages — SGL's sentinel-row masking relies on that
padding contract.

``segment_spmm`` launches the kernel for CUDA tensors and runs the
plain version, :func:`spmm_coo` (or, in the ``bf16`` and ``packed``
precisions, :func:`segment_spmm_plain`), for CPU tensors only.  ``x``
may be f32 or bf16 (``activation_dtype: bfloat16``); the kernel's
output is f32 either way, as the TPU kernel's is, and
:func:`segment_spmm_plain` is its plain version in every precision.  It is
the raw, non-differentiable launcher; gradients go through
:class:`SegmentSpmmFunction` (``ops.spmm.spmm``), whose backward is
the transpose SpMM — the same kernel over the graph's reverse CSR
(:func:`segment_spmm_transpose`), as the JAX package's custom VJP runs
the same Pallas kernel over ``rev_src``/``rev_dst``/``rev_block_ptr``
(``recbole_gnn_tpu/ops/spmm.py::_spmm_core_bwd``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from recbole_gnn_tpu_torch.ops import cuda_build

EC = 4096          # edges per chunk of the TPU layout (padding granule)
SEG_MAX = 1 << 20  # max edges per segment of the TPU layout

# peak bytes of the gathered (E, D) message array in the plain version
# before it accumulates over edge chunks
MSGS_BYTES_BUDGET = 1 << 32     # 4 GB

# edges per share of the kernel's schedule (the fastest of the sizes
# timed on an H100 at the LightGCN slice shape; PERF.md)
SHARE_EDGES = 256

# pallas_spmm_precision values, in the kernel's mode order: f32x2 runs
# the exact f32 terms, bf16 and packed form theirs as the TPU kernel does
PRECISIONS = ("f32x2", "bf16", "packed")


def segment_layout(e: int, ec: int | None = None,
                   seg_max: int | None = None) -> tuple[int, int]:
    """(n_seg, seg): smallest equal-size ec-aligned segmentation of an
    edge list of length e with seg <= seg_max (up to ec rounding)."""
    ec = ec or EC
    seg_max = max(seg_max or SEG_MAX, ec)
    e_ec = -(-max(e, 1) // ec) * ec
    n_seg = -(-e_ec // seg_max)
    seg = -(-e_ec // (n_seg * ec)) * ec
    return n_seg, seg


def pad_edges(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
              n_nodes: int, ec: int | None = None,
              seg_max: int | None = None
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort by dst and pad to the segment layout with weight-0 edges on
    the last destination row (keeps dst non-decreasing; src 0 is always
    a valid gather row even for rectangular graphs)."""
    order = np.argsort(dst, kind="stable")
    src, dst, weight = src[order], dst[order], weight[order]
    n_seg, seg = segment_layout(len(src), ec, seg_max)
    e_pad = n_seg * seg
    if e_pad > len(src):
        pad = e_pad - len(src)
        src = np.concatenate([src, np.zeros(pad, src.dtype)])
        dst = np.concatenate([dst, np.full(pad, n_nodes - 1, dst.dtype)])
        weight = np.concatenate([weight, np.zeros(pad, weight.dtype)])
    return (src.astype(np.int32), dst.astype(np.int32),
            weight.astype(np.float32))


def build_rowptr(dst_sorted: np.ndarray, n_nodes: int) -> np.ndarray:
    """CSR row pointer of a dst-sorted edge list: edges of row r are
    ``[rowptr[r], rowptr[r+1])``; (n_nodes + 1,) int64."""
    return np.searchsorted(dst_sorted, np.arange(n_nodes + 1)).astype(np.int64)


def spmm_coo(src: torch.Tensor, dst: torch.Tensor, weight: torch.Tensor,
             x: torch.Tensor, n_out: int) -> torch.Tensor:
    """The plain version: out[d] = Σ_{e: dst[e]=d} weight[e]·x[src[e]]
    by ``index_select`` × w, then ``index_add_``.

    Graphs whose (E, D) message array would exceed MSGS_BYTES_BUDGET
    accumulate over edge chunks, so it never materialises whole."""
    e, d = src.shape[0], x.shape[1]
    out = torch.zeros((n_out, d), dtype=x.dtype, device=x.device)
    chunk = max(1, min(e, MSGS_BYTES_BUDGET // max(1, 2 * d * 4)))
    for s in range(0, e, chunk):
        msgs = (x.index_select(0, src[s:s + chunk])
                * weight[s:s + chunk, None].to(x.dtype))
        out.index_add_(0, dst[s:s + chunk], msgs)
    return out


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 → bf16 rounded to nearest even → f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _hi_lo_bits(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``_hi_lo_bits``: hi = x truncated to its top
    16 bits (a bf16 value), lo = bf16(x − hi); both as f32."""
    hi = (x.contiguous().view(torch.int32) & -65536).view(torch.float32)
    return hi, _bf16(x - hi)


def pack_table(x: torch.Tensor) -> torch.Tensor:
    """The per-call pack of ``packed`` mode, the plain form of the
    kernel's pack pass: an f32 x as the sum of its hi and lo planes
    (``x̃ = hi + lo``, :func:`_hi_lo_bits`; exact in f32, since each
    part has at most 8 significant bits and lo lies below hi's last
    bit), formed once per call where the TPU kernel's wrapper packs x
    (``pallas_spmm.py:385-388``); a bf16 x as it is (hi = x, lo = 0),
    which the kernel reads without a pass."""
    if x.dtype == torch.bfloat16:
        return x
    hi, lo = _hi_lo_bits(x)
    return hi + lo


def packed_terms(table: torch.Tensor, src: torch.Tensor,
                 weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``packed`` mode's per-edge terms from the packed table
    (:func:`pack_table`): ``m = x̃[src]·w`` in f32, split into its
    truncated hi and rounded lo planes, summed apart by the kernel."""
    m = table.index_select(0, src.long()).to(torch.float32) * weight[:, None]
    return _hi_lo_bits(m)


def pack_workspace_shape(x: torch.Tensor,
                         precision: str) -> tuple[int, int] | None:
    """Shape of the kernel's f32 workspace for the packed table: x's,
    for an f32 x in ``packed`` mode; None (no pack pass) otherwise."""
    if precision == "packed" and x.dtype == torch.float32:
        return tuple(x.shape)
    return None


def segment_spmm_plain(src: torch.Tensor, dst: torch.Tensor,
                       weight: torch.Tensor, x: torch.Tensor, n_out: int,
                       precision: str = "f32x2") -> torch.Tensor:
    """The plain version of each K1 precision, its terms formed as the
    JAX package's ``_pallas_spmm_jit`` forms them and summed in f32 by
    ``index_add_``: ``f32x2`` the exact ``w·x`` (:func:`spmm_coo`);
    ``bf16`` each term ``bf16(w·x)``; ``packed`` x packed once into hi
    + lo (:func:`pack_table`), ``m = x̃·w`` per edge split again
    (:func:`packed_terms`), the two planes summed apart and added at
    the end.

    A bf16 ``x`` gives an f32 output too.  ``f32x2`` and ``bf16`` then
    take the weight rounded to bf16 (``w.astype(x.dtype)``): ``f32x2``
    sums the exact f32 products, ``bf16`` the products rounded to bf16;
    ``packed`` reads x as it is (hi = x, lo = 0) and keeps the f32
    weight."""
    _check_precision(precision)
    bf16_x = x.dtype == torch.bfloat16
    if precision == "f32x2" and not bf16_x:
        return spmm_coo(src, dst, weight, x, n_out)
    e, d = src.shape[0], x.shape[1]
    planes = 2 if precision == "packed" else 1
    out = torch.zeros((planes, n_out, d), dtype=torch.float32,
                      device=x.device)
    w = weight.to(torch.float32)
    if precision == "packed":
        x = pack_table(x)
    elif bf16_x:
        w = _bf16(w)
    chunk = max(1, min(e, MSGS_BYTES_BUDGET // max(1, 2 * d * 4)))
    for s in range(0, e, chunk):
        if precision == "packed":
            terms = packed_terms(x, src[s:s + chunk], w[s:s + chunk])
        else:
            m = (x.index_select(0, src[s:s + chunk]).to(torch.float32)
                 * w[s:s + chunk, None])
            terms = (_bf16(m),) if precision == "bf16" else (m,)
        for p, t in enumerate(terms):
            out[p].index_add_(0, dst[s:s + chunk], t)
    return out.sum(0) if precision == "packed" else out[0]


def _check_precision(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"segment_spmm: precision must be one of "
                         f"{PRECISIONS}, got {precision!r}")


@dataclass(frozen=True)
class ShareSchedule:
    """The kernel's cut of an edge list into equal shares
    (:func:`share_schedule`).

    Per share ``s`` (``n_shares`` of them, share ``s`` holding edges
    ``[s·T, (s+1)·T)`` within ``[rowptr[0], rowptr[-1])``):
    ``first_row``/``last_row``, the rows of its first and last edge (-1
    for a share with no edge of any row); ``carry_row[s, k]``, the row
    whose partial sum the share writes to carry slot ``k`` (-1: none).
    Per row ``r``: ``split``, its edges touch more than one share;
    ``first_share``/``last_share``, the shares of its first and last
    edge (last < first for an empty row); ``first_slot``, the slot of
    ``first_share`` that holds the row's first partial sum (0 where the
    row is not split)."""
    share_edges: int
    n_shares: int
    first_row: torch.Tensor
    last_row: torch.Tensor
    carry_row: torch.Tensor
    split: torch.Tensor
    first_share: torch.Tensor
    last_share: torch.Tensor
    first_slot: torch.Tensor


def share_workspace_shape(n_edges: int, d: int,
                          share_edges: int = SHARE_EDGES
                          ) -> tuple[int, int, int]:
    """Shape of the kernel's carry workspace: two D-float slots for each
    of the ⌈n_edges / share_edges⌉ shares."""
    return (-(-n_edges // share_edges), 2, d)


def share_schedule(rowptr: torch.Tensor, n_edges: int,
                   share_edges: int = SHARE_EDGES) -> ShareSchedule:
    """Which row each share starts and ends on, which rows are split and
    which carry slot each share writes — the arithmetic that
    ``csrc/segment_spmm.cu`` runs per share and per row.

    Row pointers past ``n_edges`` are read as ``n_edges``, as the kernel
    reads them.  A share's first row is the last ``r`` with
    ``rowptr[r] ≤`` its first edge (the kernel's binary search).  A row
    is split when its first and last edge lie in different shares; it
    is then its first share's last row, every later share's first row,
    and it is summed from slot 0 of those later shares after the first
    share's slot ``first_slot`` (0 when the row is also that share's
    first row, else 1)."""
    t = int(share_edges)
    if t < 1:
        raise ValueError(f"share_edges must be >= 1, got {share_edges}")
    rp = rowptr.to(torch.int64).clamp(max=n_edges)
    lo, hi = rp[0], rp[-1]
    n_shares = share_workspace_shape(n_edges, 1, t)[0]
    s = torch.arange(n_shares, dtype=torch.int64, device=rp.device)
    a = torch.maximum(s * t, lo)
    b = torch.minimum((s + 1) * t, hi)
    has = a < b
    none = torch.full_like(s, -1)
    first = torch.where(has, torch.searchsorted(rp, a, right=True) - 1, none)
    last = torch.where(has, torch.searchsorted(rp, b - 1, right=True) - 1,
                       none)
    b0, b1 = rp[:-1], rp[1:]
    nonempty = b1 > b0
    first_share = b0 // t
    last_share = torch.where(nonempty, (b1 - 1) // t, first_share - 1)
    split = last_share > first_share
    first_slot = (split & (b0 != torch.maximum(first_share * t, lo))).long()
    # a -1 row indexes the appended False
    split_at = torch.cat([split, split.new_zeros(1)])
    carry_row = torch.stack(
        [torch.where(split_at[first], first, none),
         torch.where((last != first) & split_at[last], last, none)], 1)
    return ShareSchedule(t, n_shares, first, last, carry_row, split,
                         first_share, last_share, first_slot)


def share_sum_plain(msgs: torch.Tensor, rowptr: torch.Tensor,
                    share_edges: int = SHARE_EDGES) -> torch.Tensor:
    """out[r] = Σ_{e ∈ [rowptr[r], rowptr[r+1])} msgs[e], over messages
    in edge order, computed by the share schedule in plain torch: a
    partial sum per (share, row); a row inside one share takes its
    partial; each share puts the partials of its split rows into its
    carry slots (:func:`share_schedule`); each split row is the sum of
    its carries in share order; an empty row is 0.  The schedule of
    both share kernels: K1 gathers its messages first
    (:func:`segment_spmm_shares_plain`), D1 sums them as they are
    (``ops.segment_sum.block_segment_sum_shares_plain``)."""
    n_edges, d = msgs.shape
    dev = msgs.device
    sch = share_schedule(rowptr, n_edges, share_edges)
    rp = rowptr.to(torch.int64).clamp(max=n_edges)
    n_rows = rp.shape[0] - 1
    out = torch.zeros((n_rows, d), dtype=msgs.dtype, device=dev)
    lo, hi = int(rp[0]), int(rp[-1])
    if hi <= lo:
        return out
    row = torch.repeat_interleave(torch.arange(n_rows, device=dev),
                                  rp[1:] - rp[:-1])
    key = torch.arange(lo, hi, device=dev) // sch.share_edges * n_rows + row
    new = torch.ones_like(key, dtype=torch.bool)
    new[1:] = key[1:] != key[:-1]
    run_key = key[new]                  # one (share, row) run each
    partial = torch.zeros((run_key.shape[0], d), dtype=msgs.dtype,
                          device=dev).index_add_(
        0, torch.cumsum(new, 0) - 1, msgs[lo:hi])
    run_row = run_key % n_rows
    owned = ~sch.split[run_row]
    out[run_row[owned]] = partial[owned]

    carry = torch.zeros((sch.n_shares, 2, d), dtype=msgs.dtype, device=dev)
    sh, slot = (sch.carry_row >= 0).nonzero(as_tuple=True)
    carry[sh, slot] = partial[torch.searchsorted(
        run_key, sh * n_rows + sch.carry_row[sh, slot])]
    # each split row: the carry of its first share (slot first_slot),
    # then slot 0 of each later share, added one after another in share
    # order; np.add.accumulate adds in that order, in the messages' type
    # (on the host: a row may span 10^5 shares, one add each)
    rows = sch.split.nonzero().squeeze(1)
    s0 = sch.first_share[rows]
    acc = carry[s0, sch.first_slot[rows]].cpu().numpy()
    later = carry[:, 0].cpu().numpy()
    for j, (a, n) in enumerate(zip(s0.tolist(),
                                   (sch.last_share[rows] - s0).tolist())):
        if n:
            acc[j] = np.add.accumulate(np.concatenate(
                (acc[j:j + 1], later[a + 1:a + n + 1])))[-1]
    out[rows] = torch.from_numpy(acc).to(dev)
    return out


def segment_spmm_shares_plain(src: torch.Tensor, weight: torch.Tensor,
                              rowptr: torch.Tensor, x: torch.Tensor,
                              share_edges: int = SHARE_EDGES
                              ) -> torch.Tensor:
    """out[r] = Σ_{e ∈ [rowptr[r], rowptr[r+1])} weight[e]·x[src[e]]
    computed by the kernel's schedule in plain torch: the messages
    ``weight·x[src]`` summed by :func:`share_sum_plain`.  Used by the
    tests and ``chip_smoke.py`` to check the schedule; the wrapper's
    plain version is :func:`spmm_coo`."""
    msgs = x.index_select(0, src.long()) * weight[:, None].to(x.dtype)
    return share_sum_plain(msgs, rowptr, share_edges)


def _check_cuda_args(src, dst, weight, rowptr, x):
    cuda_build.check_row_dtype("segment_spmm", "x", x)
    cuda_build.check_tensors("segment_spmm", x.device, (
        ("src", src, torch.int32, 1), ("dst", dst, torch.int32, 1),
        ("weight", weight, torch.float32, 1),
        ("rowptr", rowptr, torch.int64, 1), ("x", x, x.dtype, 2)))
    e = src.shape[0]
    if dst.shape[0] != e or weight.shape[0] != e:
        raise ValueError(
            f"segment_spmm: src/dst/weight lengths differ "
            f"({e}, {dst.shape[0]}, {weight.shape[0]})")
    if rowptr.shape[0] < 1:
        raise ValueError("segment_spmm: rowptr needs n_rows + 1 >= 1 entries")


def segment_spmm(src: torch.Tensor, dst: torch.Tensor, weight: torch.Tensor,
                 rowptr: torch.Tensor, x: torch.Tensor,
                 precision: str = "f32x2") -> torch.Tensor:
    """out[r] = Σ_{e ∈ [rowptr[r], rowptr[r+1])} weight[e]·x[src[e]].

    Edges are sorted by ``dst`` and ``rowptr`` is their CSR row pointer
    (:func:`build_rowptr`); the output has ``len(rowptr) - 1`` rows.
    ``precision`` (one of ``PRECISIONS``) says how each term is formed
    (:func:`segment_spmm_plain`).  A CUDA ``x`` launches the kernel (f32
    or bf16 ``x``, read as it is, f32 ``weight``, int32 ``src``/``dst``,
    int64 ``rowptr``, all contiguous on one card; any other input
    raises) over shares of ``SHARE_EDGES`` edges, with a carry workspace
    of :func:`share_workspace_shape` (and, for an f32 x in ``packed``,
    one of :func:`pack_workspace_shape` for its packed table); one
    launch runs the pack pass where there is one, the share pass and the
    carry pass.  The output is f32.  A CPU ``x`` runs
    :func:`spmm_coo` in ``f32x2``, in x's dtype (the JAX package's path
    off the TPU, which a bf16 x keeps bf16; the f32x2 kernel's plain
    version for a bf16 x is :func:`segment_spmm_plain`), or
    :func:`segment_spmm_plain`.  ``segment_spmm.launches`` counts kernel
    launches."""
    n_rows = rowptr.shape[0] - 1
    if x.device.type == "cpu":
        if precision == "f32x2":
            return spmm_coo(src, dst, weight, x, n_rows)
        return segment_spmm_plain(src, dst, weight, x, n_rows, precision)
    if x.device.type != "cuda":
        raise ValueError(f"segment_spmm: unsupported device {x.device}")
    out = _segment_spmm_cuda(src, dst, weight, rowptr, x, SHARE_EDGES,
                             precision)
    if out.numel():                 # an empty output launches nothing
        segment_spmm.launches += 1
    return out


segment_spmm.launches = 0


def _segment_spmm_cuda(src, dst, weight, rowptr, x, share_edges: int,
                       precision: str = "f32x2") -> torch.Tensor:
    """The kernel over shares of ``share_edges`` edges, on CUDA tensors;
    counts nothing and launches nothing for an empty output.
    ``chip_smoke.py`` calls it to check other share sizes; the C entry
    point refuses a size whose shares do not fit in shared memory."""
    _check_precision(precision)
    _check_cuda_args(src, dst, weight, rowptr, x)
    n_rows = rowptr.shape[0] - 1
    e, d = src.shape[0], x.shape[1]
    out = torch.empty((n_rows, d), dtype=torch.float32, device=x.device)
    if n_rows == 0 or d == 0:
        return out
    carry = torch.empty(share_workspace_shape(e, d, share_edges),
                        dtype=torch.float32, device=x.device)
    pack_shape = pack_workspace_shape(x, precision)
    xpack = (None if pack_shape is None else
             torch.empty(pack_shape, dtype=torch.float32, device=x.device))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.segment_spmm_launch(
            x.data_ptr(), src.data_ptr(), weight.data_ptr(),
            dst.data_ptr(), rowptr.data_ptr(), out.data_ptr(),
            carry.data_ptr(), None if xpack is None else xpack.data_ptr(),
            n_rows, x.shape[0], e, d, cuda_build.vec_width(x), share_edges,
            PRECISIONS.index(precision), int(x.dtype == torch.bfloat16),
            stream)
    if rc != 0:
        raise RuntimeError(f"segment_spmm launch failed: CUDA error {rc}")
    return out


def segment_spmm_transpose(rev_src: torch.Tensor, rev_dst: torch.Tensor,
                           rev_weight: torch.Tensor, rev_rowptr: torch.Tensor,
                           g: torch.Tensor,
                           precision: str = "f32x2") -> torch.Tensor:
    """The transpose SpMM, dL/dx of :func:`segment_spmm`:

        gx[s] = Σ_{e: src[e]=s} w[e]·g[dst[e]]

    run as :func:`segment_spmm` over the reverse CSR (edges sorted by
    the original ``src``; ``rev_src`` holds the original ``dst``), so
    the output has ``len(rev_rowptr) - 1`` = n_src_nodes rows.  ``g`` is
    made contiguous first (a cotangent is often a broadcast or a
    slice).  ``segment_spmm_transpose.launches`` counts the launches
    made here; ``segment_spmm.launches`` counts them too."""
    before = segment_spmm.launches
    out = segment_spmm(rev_src, rev_dst, rev_weight, rev_rowptr,
                       g.contiguous(), precision)
    segment_spmm_transpose.launches += segment_spmm.launches - before
    return out


segment_spmm_transpose.launches = 0


class SegmentSpmmFunction(torch.autograd.Function):
    """Differentiable SpMM over a dst-sorted graph with a reverse CSR.

    ``apply(x, weight, graph, weight_grad)``: ``graph`` carries ``src``,
    ``dst``, ``rowptr`` and the reverse arrays ``rev_src``, ``rev_dst``,
    ``rev_weight``, ``rev_rowptr`` (``ops.spmm.Graph``); ``weight`` is
    its edge weight, passed apart so that autograd can see it.

    Forward: :func:`segment_spmm` in the graph's ``precision`` on a
    CUDA tensor (an f32 output, for a bf16 x too, as the TPU kernel
    gives); a CPU tensor runs ``f32x2``, :func:`spmm_coo` in x's dtype,
    as the JAX package runs its Pallas kernel, and so its precision, on
    the TPU only, and ``spmm_coo`` elsewhere.  Backward: the x-cotangent
    is :func:`segment_spmm_transpose` in the same precision on the
    cotangent as it comes (f32 on the card) — the CUDA kernel for a
    CUDA tensor, the plain ``spmm_coo`` over the same reverse arrays
    for a CPU one; autograd hands it on in x's dtype and never
    differentiates ``spmm_coo`` here.  The weight
    cotangent is ``None`` unless ``weight_grad``; then it is
    ``gw[e] = Σ_d x[src[e], d]·g[dst[e], d]`` in plain torch, as the
    JAX package computes it with XLA ops (``spmm.py:352-355``)."""

    @staticmethod
    def forward(ctx, x, weight, graph, weight_grad):
        ctx.graph = graph
        ctx.weight_grad = bool(weight_grad)
        ctx.precision = (graph.precision if x.device.type == "cuda"
                         else "f32x2")
        ctx.save_for_backward(x if ctx.weight_grad else None, weight)
        return segment_spmm(graph.src, graph.dst, weight, graph.rowptr, x,
                            ctx.precision)

    @staticmethod
    def backward(ctx, g):
        graph = ctx.graph
        x, weight = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = segment_spmm_transpose(graph.rev_src, graph.rev_dst,
                                        reverse_weight(graph, weight),
                                        graph.rev_rowptr, g, ctx.precision)
        if ctx.weight_grad and ctx.needs_input_grad[1]:
            gw = weight_cotangent(graph, x, g)
        return gx, gw, None, None


def reverse_weight(graph, weight: torch.Tensor) -> torch.Tensor:
    """The edge weights in the transposed ordering: the graph's
    ``rev_weight``, or ``weight[rev_edge_id]`` gathered now when it has
    none (a re-weighted graph, ``Graph.with_weight``), as the JAX
    package's ``_spmm_core_bwd`` does (``spmm.py:341-347``)."""
    if graph.rev_weight is not None:
        return graph.rev_weight
    return weight.index_select(0, graph.rev_edge_id.long())


def weight_cotangent(graph, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dw[e] = x[src[e]]·g[dst[e]], in plain torch as the JAX package
    computes it with XLA ops (``spmm.py:352-355``)."""
    return (x.index_select(0, graph.src.long())
            * g.index_select(0, graph.dst.long())).sum(-1)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("segment_spmm")
    fn = lib.segment_spmm_launch
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        ll, i = ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ll, ll, ll, i, i, i,
                       i, i, vp]
        fn.restype = ctypes.c_int
    return lib
