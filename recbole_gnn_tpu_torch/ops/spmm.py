"""Sparse adjacency × dense feature products (SpMM).

Port of ``recbole_gnn_tpu/ops/spmm.py``.  A sparse graph is a static
COO triple sorted by destination row, built once on the host, plus its
CSR row pointer; the dense bipartite form holds the normalised
user-item block as one matrix.

Implementation switch (config ``sparse_spmm_impl``, carried on the
``Graph`` rather than in a module global):

  * ``pallas``: the segment SpMM kernel (``ops/segment_spmm.py``,
    ``csrc/segment_spmm.cu``), the port of the Pallas streaming kernel.
  * ``ell`` / ``xla``: bucketed-ELL and the XLA segment-sum are not
    ported yet (ROADMAP K2, K3); on a CUDA tensor they raise.

``pallas_spmm_precision``: ``f32x2`` runs the f32 kernel, which is at
least as exact; ``packed`` and ``bf16`` raise on a CUDA tensor.

On CPU tensors every value runs the plain version, ``spmm_coo``, as the
JAX package ignores ``pallas`` off the TPU.  A CUDA tensor runs the
kernel or raises; it never takes the plain version.

Gradients: ``spmm`` goes through ``SegmentSpmmFunction``, whose backward
is the transpose SpMM over the graph's reverse CSR — the port of the
custom VJP ``_spmm_core`` (``recbole_gnn_tpu/ops/spmm.py:315-359``).
The dense bipartite form stays a pair of ``torch.matmul`` under
autograd, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from recbole_gnn_tpu_torch.ops.segment_spmm import (
    SegmentSpmmFunction, build_rowptr, pad_edges, segment_spmm, spmm_coo)

SPMM_IMPLS = ("ell", "xla", "pallas")
SPMM_PRECISIONS = ("packed", "f32x2", "bf16")

__all__ = ["Graph", "BipartiteDenseGraph", "build_graph",
           "build_dense_bipartite", "spmm", "spmm_any", "spmm_coo",
           "spmm_dense_bipartite", "SPMM_IMPLS", "SPMM_PRECISIONS"]


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
        return Graph(self.rev_src, self.rev_dst, self.rev_weight,
                     self.rev_rowptr, self.n_src_nodes, self.n_nodes,
                     self.nnz, rev_src=self.src, rev_dst=self.dst,
                     rev_edge_id=inv, rev_weight=self.weight,
                     rev_rowptr=self.rowptr, impl=self.impl,
                     precision=self.precision)


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
    if graph.impl in ("ell", "xla"):
        row = {"ell": "K2", "xla": "K3"}[graph.impl]
        raise NotImplementedError(
            f"sparse_spmm_impl={graph.impl!r} has no CUDA kernel yet "
            f"(ROADMAP {row}); use sparse_spmm_impl=pallas on the card")
    if graph.precision != "f32x2":
        raise NotImplementedError(
            f"pallas_spmm_precision={graph.precision!r} has no CUDA kernel "
            "yet; use f32x2 (runs the exact f32 kernel)")


def spmm(graph: Graph, x: torch.Tensor,
         weight_grad: bool = False) -> torch.Tensor:
    """SpMM over a :class:`Graph` → (graph.n_nodes, D), differentiable.

    CUDA: the segment SpMM kernel (``impl='pallas'``) or a raise, forward
    and backward.  CPU: the plain version, whatever ``impl`` says.
    The x-gradient is the transpose SpMM over the reverse CSR.

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
        return segment_spmm(graph.src, graph.dst, graph.weight,
                            graph.rowptr, x)
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
