"""Sparse adjacency × dense feature products (SpMM).

Port of ``recbole_gnn_tpu/ops/spmm.py``.  A sparse graph is a static
COO triple sorted by destination row, built once on the host, plus its
CSR row pointer; the dense bipartite form holds the normalised
user-item block as one matrix.

Implementation switch (config ``sparse_spmm_impl``, carried on the
``Graph`` rather than in a module global):

  * ``pallas``: the segment SpMM kernel (``ops/segment_spmm.py``,
    ``csrc/segment_spmm.cu``), the port of the Pallas streaming kernel.
  * ``xla``: the JAX package's gather + sorted segment-sum
    (``spmm_coo`` / ``_spmm_coo_chunked``), here :func:`xla_spmm`: the
    row gather kernel (``ops/gather.py``, D2) makes the messages and the
    block segment sum kernel (``ops/segment_sum.py``, D1) reduces them,
    over edge chunks above ``MSGS_BYTES_BUDGET``.
  * ``ell``: bucketed-ELL is not ported yet (ROADMAP K2); on a CUDA
    tensor it raises.

``pallas_spmm_precision``: for ``pallas``, ``f32x2`` runs the f32
kernel, which is at least as exact; ``packed`` and ``bf16`` raise on a
CUDA tensor.  The JAX package reads it only on the Pallas path, so the
other implementations ignore it.

On CPU tensors an ``xla`` graph runs the same composition through the
plain versions of D2 and D1; every other value runs the plain version
``spmm_coo``, as the JAX package ignores ``pallas`` off the TPU.  A
CUDA tensor runs the kernels or raises; it never takes a plain version.

Gradients: ``spmm`` goes through ``SegmentSpmmFunction`` (``pallas``)
or ``CooSpmmFunction`` (``xla``), whose backward is the transpose SpMM
over the graph's reverse CSR, run by the same kernels — the port of the
custom VJP ``_spmm_core`` (``recbole_gnn_tpu/ops/spmm.py:315-359``).
The dense bipartite form stays a pair of ``torch.matmul`` under
autograd, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from recbole_gnn_tpu_torch.ops import segment_spmm as _seg
from recbole_gnn_tpu_torch.ops.gather import row_gather
from recbole_gnn_tpu_torch.ops.segment_spmm import (
    SegmentSpmmFunction, build_rowptr, pad_edges, reverse_weight,
    segment_spmm, spmm_coo, weight_cotangent)
from recbole_gnn_tpu_torch.ops.segment_sum import block_segment_sum

SPMM_IMPLS = ("ell", "xla", "pallas")
SPMM_PRECISIONS = ("packed", "f32x2", "bf16")

__all__ = ["Graph", "BipartiteDenseGraph", "CooSpmmFunction", "build_graph",
           "build_dense_bipartite", "spmm", "spmm_any", "spmm_coo",
           "spmm_dense_bipartite", "xla_spmm", "SPMM_IMPLS",
           "SPMM_PRECISIONS"]


@dataclass
class Graph:
    """Static COO graph, edges sorted by ``dst``, with its CSR row
    pointer and the transposed ordering (for the backward).

    Attributes:
      src: (E,) int32 source node per edge.
      dst: (E,) int32 destination node per edge, non-decreasing.
      weight: (E,) float32 edge weight (0.0 == masked/padding edge).
      rowptr: (n_nodes + 1,) int64 — edges of row r are
        ``[rowptr[r], rowptr[r+1])``.
      rev_src / rev_dst / rev_edge_id / rev_weight / rev_rowptr: the
        transposed edge list (sorted by the new dst = original src),
        the original index of each transposed edge, its weight and row
        pointer; None when built without the reverse ordering.
        ``rev_weight`` is also None after ``with_weight`` without one:
        the backward then gathers ``weight[rev_edge_id]`` per call.
      n_nodes: number of destination nodes (output rows).
      n_src_nodes: number of source nodes (input rows).
      nnz: real edges (excluding the weight-0 padding).
      impl / precision: the ``sparse_spmm_impl`` and
        ``pallas_spmm_precision`` this graph runs with.
    """

    src: torch.Tensor
    dst: torch.Tensor
    weight: torch.Tensor
    rowptr: torch.Tensor
    n_nodes: int
    n_src_nodes: int
    nnz: int
    rev_src: torch.Tensor | None = None
    rev_dst: torch.Tensor | None = None
    rev_edge_id: torch.Tensor | None = None
    rev_weight: torch.Tensor | None = None
    rev_rowptr: torch.Tensor | None = None
    impl: str = "pallas"
    precision: str = "f32x2"

    @property
    def n_edges(self) -> int:
        """Real (unpadded) edge count."""
        return self.nnz

    @property
    def n_edges_padded(self) -> int:
        return self.src.shape[0]

    def reverse(self) -> "Graph":
        """Transposed view (swaps the stored orderings; no host work)."""
        if self.rev_src is None:
            raise ValueError("graph built without reverse ordering")
        # the transpose's own reverse list is this graph's dst-sorted
        # edge list; edge k there is reverse edge inv[k]
        inv = torch.argsort(self.rev_edge_id).to(torch.int32)
        return Graph(self.rev_src, self.rev_dst,
                     reverse_weight(self, self.weight),
                     self.rev_rowptr, self.n_src_nodes, self.n_nodes,
                     self.nnz, rev_src=self.src, rev_dst=self.dst,
                     rev_edge_id=inv, rev_weight=self.weight,
                     rev_rowptr=self.rowptr, impl=self.impl,
                     precision=self.precision)

    def with_weight(self, weight: torch.Tensor,
                    rev_weight: torch.Tensor | None = None) -> "Graph":
        """New graph with re-weighted edges (dropout / augmentation), as
        the JAX package's ``Graph.with_weight``.  Pass ``rev_weight``
        (= ``weight[rev_edge_id]``) if it is cheap to have (once per
        epoch); otherwise the backward gathers it per call.  The JAX
        package clears the baked ELL layouts here, so a re-weighted
        ``ell`` graph runs the segment-sum path: its impl becomes
        ``xla``."""
        return replace(self, weight=weight, rev_weight=rev_weight,
                       impl="xla" if self.impl == "ell" else self.impl)


def build_graph(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
                n_nodes: int, n_src_nodes: int | None = None, *,
                device: torch.device | str,
                with_reverse: bool = True, with_pallas: bool = False,
                impl: str = "pallas", precision: str = "f32x2") -> Graph:
    """Host-side constructor: sorts edges by dst (stable), builds the
    row pointer and, with ``with_reverse``, the transposed ordering.
    With ``with_pallas`` the edge list is padded to the TPU kernel's
    segment layout (``pad_edges``), so the padded arrays equal the JAX
    package's element for element."""
    if impl not in SPMM_IMPLS:
        raise ValueError(f"sparse_spmm_impl must be one of {SPMM_IMPLS}, "
                         f"got {impl!r}")
    if precision not in SPMM_PRECISIONS:
        raise ValueError(f"pallas_spmm_precision must be one of "
                         f"{SPMM_PRECISIONS}, got {precision!r}")
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    weight = np.asarray(weight, dtype=np.float32)
    if n_src_nodes is None:
        n_src_nodes = n_nodes
    if len(src) and (src.min() < 0 or src.max() >= n_src_nodes
                     or dst.min() < 0 or dst.max() >= n_nodes):
        raise ValueError("build_graph: edge endpoint out of range")
    nnz = len(src)
    if with_pallas:
        src, dst, weight = pad_edges(src, dst, weight, n_nodes)
    else:
        order = np.argsort(dst, kind="stable")
        src, dst, weight = src[order], dst[order], weight[order]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    g = Graph(t(src), t(dst), t(weight), t(build_rowptr(dst, n_nodes)),
              int(n_nodes), int(n_src_nodes), int(nnz),
              impl=impl, precision=precision)
    if with_reverse:
        rev_order = np.argsort(src, kind="stable").astype(np.int32)
        rev_dst = src[rev_order]
        g.rev_src = t(dst[rev_order])
        g.rev_dst = t(rev_dst)
        g.rev_edge_id = t(rev_order)
        g.rev_weight = t(weight[rev_order])
        g.rev_rowptr = t(build_rowptr(rev_dst, n_src_nodes))
    return g


def _check_cuda_impl(graph: Graph):
    if graph.impl == "ell":
        raise NotImplementedError(
            "sparse_spmm_impl='ell' has no CUDA kernel yet (ROADMAP K2); "
            "use sparse_spmm_impl=pallas or xla on the card")
    if graph.impl == "pallas" and graph.precision != "f32x2":
        raise NotImplementedError(
            f"pallas_spmm_precision={graph.precision!r} has no CUDA kernel "
            "yet; use f32x2 (runs the exact f32 kernel)")


def xla_spmm(src: torch.Tensor, dst: torch.Tensor, weight: torch.Tensor,
             rowptr: torch.Tensor, x: torch.Tensor,
             chunk: int | None = None) -> torch.Tensor:
    """out[r] = Σ_{e ∈ [rowptr[r], rowptr[r+1])} weight[e]·x[src[e]] as
    ``sparse_spmm_impl: xla`` computes it: the messages ``x[src]·w``
    by :func:`row_gather`, then their sorted sum by
    :func:`block_segment_sum` (f32 mode) into ``len(rowptr) - 1`` rows.

    Above ``MSGS_BYTES_BUDGET`` of messages, or with ``chunk``, it runs
    over edge chunks of ``chunk`` edges as the JAX package's
    ``_spmm_coo_chunked`` does, each chunk's sum added into one output
    through the chunk's clamped row pointer ``rowptr.clamp(s, s+c) - s``
    (the same sum as JAX's weight-0 padding onto the last node)."""
    e, d = src.shape[0], x.shape[1]
    if chunk is None and e * d * 4 > _seg.MSGS_BYTES_BUDGET:
        chunk = _seg.MSGS_BYTES_BUDGET // (2 * d * 4)
    chunk = max(1, e if chunk is None else chunk)
    out = None
    for s in range(0, max(e, 1), chunk):
        c = min(chunk, e - s)
        msgs = row_gather(x, src[s:s + c])
        # in place: the (c, D) message array is the peak, and a product
        # into a new tensor would double it
        msgs.mul_(weight[s:s + c, None])
        rp = rowptr if c == e else rowptr.clamp(s, s + c) - s
        out = block_segment_sum(msgs, dst[s:s + c], rp, "f32", out=out)
    return out


class CooSpmmFunction(torch.autograd.Function):
    """Differentiable ``xla`` SpMM over a dst-sorted graph with a
    reverse CSR — the port of ``_spmm_core`` with neither ELL nor
    Pallas selected (``recbole_gnn_tpu/ops/spmm.py:345-355``).

    ``apply(x, weight, graph, weight_grad)``: forward :func:`xla_spmm`
    over ``src``/``dst``/``rowptr``; the x-cotangent is the same
    composition over ``rev_src``/``rev_dst``/``rev_rowptr`` with
    ``rev_weight`` (gathered as ``weight[rev_edge_id]`` when the graph
    has none); the weight cotangent as in ``SegmentSpmmFunction``."""

    @staticmethod
    def forward(ctx, x, weight, graph, weight_grad):
        ctx.graph = graph
        ctx.weight_grad = bool(weight_grad)
        ctx.save_for_backward(x if ctx.weight_grad else None, weight)
        return xla_spmm(graph.src, graph.dst, weight, graph.rowptr, x)

    @staticmethod
    def backward(ctx, g):
        graph = ctx.graph
        x, weight = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = xla_spmm(graph.rev_src, graph.rev_dst,
                          reverse_weight(graph, weight), graph.rev_rowptr,
                          g.contiguous())
        if ctx.weight_grad and ctx.needs_input_grad[1]:
            gw = weight_cotangent(graph, x, g)
        return gx, gw, None, None


def spmm(graph: Graph, x: torch.Tensor,
         weight_grad: bool = False) -> torch.Tensor:
    """SpMM over a :class:`Graph` → (graph.n_nodes, D), differentiable.

    CUDA: the kernels of ``graph.impl`` (``pallas``: the segment SpMM;
    ``xla``: row gather + block segment sum) or a raise, forward and
    backward.  CPU: ``xla`` runs its composition on the plain versions
    of its kernels, every other impl the plain ``spmm_coo``.  The
    x-gradient is the transpose SpMM over the reverse CSR.

    ``weight_grad``: no model learns edge weights, so by default the
    weight cotangent is skipped; pass True to differentiate with respect
    to ``graph.weight``.

    A graph built without the reverse ordering has no transpose to run:
    on the CPU autograd differentiates ``spmm_coo`` (as the JAX package
    does, ``spmm.py:374-375``); on the card a gradient raises."""
    cuda = x.device.type == "cuda"
    if cuda:
        _check_cuda_impl(graph)
    if graph.rev_src is None:
        if not cuda:
            return spmm_coo(graph.src, graph.dst, graph.weight, x,
                            graph.n_nodes)
        if torch.is_grad_enabled() and (x.requires_grad or (
                weight_grad and graph.weight.requires_grad)):
            raise ValueError(
                "spmm: this graph was built with with_reverse=False, so "
                "its backward (the transpose SpMM over the reverse CSR) "
                "cannot run on the card; build it with with_reverse=True")
        if graph.impl == "xla":
            return xla_spmm(graph.src, graph.dst, graph.weight,
                            graph.rowptr, x)
        return segment_spmm(graph.src, graph.dst, graph.weight,
                            graph.rowptr, x)
    if graph.impl == "xla":
        return CooSpmmFunction.apply(x, graph.weight, graph, weight_grad)
    return SegmentSpmmFunction.apply(x, graph.weight, graph, weight_grad)


@dataclass
class BipartiteDenseGraph:
    """Dense normalised bipartite adjacency.

    ``a`` is the (n_users, n_items) sym-normalised block of the lifted
    square adjacency [[0, A], [Aᵀ, 0]] — propagation semantics identical
    to the COO path."""

    a: torch.Tensor
    n_users: int
    n_items: int
    nnz: int

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items

    @property
    def n_edges(self) -> int:
        return 2 * self.nnz


def build_dense_bipartite(users: np.ndarray, items: np.ndarray,
                          weights: np.ndarray, n_users: int, n_items: int,
                          *, device: torch.device | str,
                          dtype: torch.dtype = torch.float32
                          ) -> BipartiteDenseGraph:
    """Densify a (user, item, weight) COO block (duplicates summed)."""
    a = np.zeros((n_users, n_items), dtype=np.float32)
    np.add.at(a, (users, items), weights)
    return BipartiteDenseGraph(torch.from_numpy(a).to(device=device, dtype=dtype),
                               int(n_users), int(n_items), len(users))


def spmm_dense_bipartite(graph: BipartiteDenseGraph,
                         x: torch.Tensor) -> torch.Tensor:
    """Two dense products (U←A·I, I←Aᵀ·U), left to cuBLAS as the JAX
    package leaves them to XLA; a bf16-stored ``a`` is widened to x's
    dtype first."""
    a = graph.a if graph.a.dtype == x.dtype else graph.a.to(x.dtype)
    xu, xi = x[:graph.n_users], x[graph.n_users:]
    return torch.cat([torch.matmul(a, xi), torch.matmul(a.T, xu)], dim=0)


def spmm_any(graph, x: torch.Tensor) -> torch.Tensor:
    """Dispatch over graph representations (dense bipartite | COO)."""
    if isinstance(graph, BipartiteDenseGraph):
        return spmm_dense_bipartite(graph, x)
    return spmm(graph, x)
