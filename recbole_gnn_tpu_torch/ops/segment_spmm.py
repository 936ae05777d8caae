"""Segment SpMM over dst-sorted edges — the port's CUDA kernel.

Counterpart of ``recbole_gnn_tpu/ops/pallas_spmm.py``.  Both compute

    out[d] = Σ_{e: dst[e]=d} w[e] · x[src[e]]

over an edge list sorted by destination and padded with weight-0
edges.  The Pallas kernel streamed a materialised message array in
≤ 2²⁰-edge segments through one-hot MXU products; the Hopper kernel
(``csrc/segment_spmm.cu``) gathers ``x[src]`` itself, one warp per
destination row, driven by a CSR row pointer built here on the host
(the counterpart of ``build_pallas_meta``).

The host padding (``segment_layout``/``pad_edges``) is a copy of the
JAX package's, so a padded ``Graph`` holds the same arrays element for
element in both packages — SGL's sentinel-row masking relies on that
padding contract.

``segment_spmm`` launches the kernel for CUDA tensors and runs the
plain version, :func:`spmm_coo`, for CPU tensors only.  It is the raw,
non-differentiable launcher; gradients go through
:class:`SegmentSpmmFunction` (``ops.spmm.spmm``), whose backward is
the transpose SpMM — the same kernel over the graph's reverse CSR
(:func:`segment_spmm_transpose`), as the JAX package's custom VJP runs
the same Pallas kernel over ``rev_src``/``rev_dst``/``rev_block_ptr``
(``recbole_gnn_tpu/ops/spmm.py::_spmm_core_bwd``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from recbole_gnn_tpu_torch.ops import cuda_build

EC = 4096          # edges per chunk of the TPU layout (padding granule)
SEG_MAX = 1 << 20  # max edges per segment of the TPU layout

# peak bytes of the gathered (E, D) message array in the plain version
# before it accumulates over edge chunks
MSGS_BYTES_BUDGET = 1 << 32     # 4 GB


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


def _check_cuda_args(src, dst, weight, rowptr, x):
    cuda_build.check_tensors("segment_spmm", x.device, (
        ("src", src, torch.int32, 1), ("dst", dst, torch.int32, 1),
        ("weight", weight, torch.float32, 1),
        ("rowptr", rowptr, torch.int64, 1), ("x", x, torch.float32, 2)))
    e = src.shape[0]
    if dst.shape[0] != e or weight.shape[0] != e:
        raise ValueError(
            f"segment_spmm: src/dst/weight lengths differ "
            f"({e}, {dst.shape[0]}, {weight.shape[0]})")
    if rowptr.shape[0] < 1:
        raise ValueError("segment_spmm: rowptr needs n_rows + 1 >= 1 entries")


def segment_spmm(src: torch.Tensor, dst: torch.Tensor, weight: torch.Tensor,
                 rowptr: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[r] = Σ_{e ∈ [rowptr[r], rowptr[r+1])} weight[e]·x[src[e]].

    Edges are sorted by ``dst`` and ``rowptr`` is their CSR row pointer
    (:func:`build_rowptr`); the output has ``len(rowptr) - 1`` rows.
    A CUDA ``x`` launches the kernel (f32 ``x``/``weight``, int32
    ``src``/``dst``, int64 ``rowptr``, all contiguous on one card; any
    other input raises).  A CPU ``x`` runs :func:`spmm_coo`.
    ``segment_spmm.launches`` counts kernel launches."""
    n_rows = rowptr.shape[0] - 1
    if x.device.type == "cpu":
        return spmm_coo(src, dst, weight, x, n_rows)
    if x.device.type != "cuda":
        raise ValueError(f"segment_spmm: unsupported device {x.device}")
    _check_cuda_args(src, dst, weight, rowptr, x)
    d = x.shape[1]
    out = torch.empty((n_rows, d), dtype=torch.float32, device=x.device)
    if n_rows == 0 or d == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.segment_spmm_f32(
            x.data_ptr(), src.data_ptr(), weight.data_ptr(),
            rowptr.data_ptr(), out.data_ptr(), n_rows, d,
            cuda_build.vec_width(x), stream)
    if rc != 0:
        raise RuntimeError(f"segment_spmm launch failed: CUDA error {rc}")
    segment_spmm.launches += 1
    return out


segment_spmm.launches = 0


def segment_spmm_transpose(rev_src: torch.Tensor, rev_dst: torch.Tensor,
                           rev_weight: torch.Tensor, rev_rowptr: torch.Tensor,
                           g: torch.Tensor) -> torch.Tensor:
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
                       g.contiguous())
    segment_spmm_transpose.launches += segment_spmm.launches - before
    return out


segment_spmm_transpose.launches = 0


class SegmentSpmmFunction(torch.autograd.Function):
    """Differentiable SpMM over a dst-sorted graph with a reverse CSR.

    ``apply(x, weight, graph, weight_grad)``: ``graph`` carries ``src``,
    ``dst``, ``rowptr`` and the reverse arrays ``rev_src``, ``rev_dst``,
    ``rev_weight``, ``rev_rowptr`` (``ops.spmm.Graph``); ``weight`` is
    its edge weight, passed apart so that autograd can see it.

    Forward: :func:`segment_spmm`.  Backward: the x-cotangent is
    :func:`segment_spmm_transpose` — the CUDA kernel for a CUDA tensor,
    the plain ``spmm_coo`` over the same reverse arrays for a CPU one;
    autograd never differentiates ``spmm_coo`` here.  The weight
    cotangent is ``None`` unless ``weight_grad``; then it is
    ``gw[e] = Σ_d x[src[e], d]·g[dst[e], d]`` in plain torch, as the
    JAX package computes it with XLA ops (``spmm.py:352-355``)."""

    @staticmethod
    def forward(ctx, x, weight, graph, weight_grad):
        ctx.graph = graph
        ctx.weight_grad = bool(weight_grad)
        ctx.save_for_backward(x if ctx.weight_grad else None, weight)
        return segment_spmm(graph.src, graph.dst, weight, graph.rowptr, x)

    @staticmethod
    def backward(ctx, g):
        graph = ctx.graph
        x, weight = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = segment_spmm_transpose(graph.rev_src, graph.rev_dst,
                                        reverse_weight(graph, weight),
                                        graph.rev_rowptr, g)
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
    fn = lib.segment_spmm_f32
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return lib
