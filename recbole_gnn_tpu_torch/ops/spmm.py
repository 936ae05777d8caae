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
    block segment sum kernel (``ops/segment_sum.py``, D1) weights and
    reduces them, over edge chunks above ``MSGS_BYTES_BUDGET``.
  * ``ell`` (the config default): the bucketed-ELL SpMM
    (``ops/ell_spmm.py``, ``csrc/ell_spmm.cu``, K2) over the layouts
    ``Graph.ell`` / ``Graph.rev_ell`` that ``build_graph`` builds for an
    ``ell`` graph.  An ``ell`` graph without them (built without, or
    re-weighted by ``with_weight``) runs the ``xla`` composition, as
    the JAX package runs its segment sum there.

``pallas_spmm_precision``, for ``pallas`` on a CUDA tensor: ``f32x2``
runs the exact f32 terms, ``bf16`` and ``packed`` form their terms as
the TPU kernel does (``ops/segment_spmm.py``).  The JAX package reads it
only on the Pallas path, so the other implementations ignore it.

On CPU tensors an ``xla`` graph runs the same composition through the
plain versions of D2 and D1 and an ``ell`` graph with its layouts the
plain ``ell_spmm``; ``pallas`` runs the plain version ``spmm_coo`` in
x's dtype, as the JAX package ignores ``pallas`` off the TPU.  A CUDA
tensor runs the kernels or raises; it never takes a plain version.

A bf16 ``x`` (``activation_dtype: bfloat16``) goes through as it is,
with the output dtypes of the JAX package: bf16 on ``ell`` and ``xla``
(K2, and D2 + D1, read bf16 rows and round each output once), f32 on
``pallas`` on the card (K1 gives f32, as the TPU kernel does) and bf16
on the CPU (``spmm_coo``), and f32 on the dense form (the promoted
dtype of ``jnp.dot(..., preferred_element_type=f32)``).

Gradients: ``spmm`` goes through ``EllSpmmFunction`` (``ell``),
``SegmentSpmmFunction`` (``pallas``) or ``CooSpmmFunction`` (``xla``),
whose backward is the transpose SpMM — over the transpose layout or the
reverse CSR, run by the same kernels — the port of the custom VJP
``_spmm_core`` (``recbole_gnn_tpu/ops/spmm.py:315-359``).  The dense
bipartite form stays a pair of ``torch.matmul`` under autograd, as the
JAX package leaves it to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from recbole_gnn_tpu_torch.ops import segment_spmm as _seg
from recbole_gnn_tpu_torch.ops.ell_spmm import (EllMeta, build_ell,
                                                ell_reweight, ell_spmm,
                                                ell_spmm_transpose)
from recbole_gnn_tpu_torch.ops.gather import row_gather
from recbole_gnn_tpu_torch.ops.segment_spmm import (
    SegmentSpmmFunction, build_rowptr, pad_edges, reverse_weight,
    segment_spmm, spmm_coo, weight_cotangent)
from recbole_gnn_tpu_torch.ops.segment_sum import block_segment_sum

SPMM_IMPLS = ("ell", "xla", "pallas")
SPMM_PRECISIONS = ("packed", "f32x2", "bf16")

__all__ = ["Graph", "BipartiteDenseGraph", "CooSpmmFunction",
           "EllSpmmFunction", "build_graph",
           "build_dense_bipartite", "spmm", "spmm_any", "spmm_coo",
           "spmm_dense_bipartite", "spmm_dense_bipartite_dropout",
           "dense_dropout_masks", "dense_dtype", "graph_impl", "matvec_any",
           "xla_spmm",
           "SPMM_IMPLS",
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
      ell / rev_ell: the bucketed-ELL layouts of the real edges
        (``ops/ell_spmm.EllMeta``), forward (reduce by dst) and
        transpose (reduce by src), their slot edge ids in the canonical
        dst-sorted order; None unless built for an ``ell`` graph.
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
    ell: EllMeta | None = None
    rev_ell: EllMeta | None = None

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
                     precision=self.precision, ell=self.rev_ell,
                     rev_ell=self.ell)

    def with_weight(self, weight: torch.Tensor,
                    rev_weight: torch.Tensor | None = None,
                    rebuild_ell: bool = False) -> "Graph":
        """New graph with re-weighted edges (dropout / augmentation), as
        the JAX package's ``Graph.with_weight``.  Pass ``rev_weight``
        (= ``weight[rev_edge_id]``) if it is cheap to have (once per
        epoch); otherwise the backward gathers it per call.

        The ELL layouts bake the weights in.  With ``rebuild_ell`` (and
        layouts that record their slots' edge ids) both are re-weighted
        from ``weight[:n_edges]`` (the pallas padding stripped) and the
        graph stays on ``ell``; otherwise they are cleared and a
        re-weighted ``ell`` graph runs the segment-sum path: its impl
        becomes ``xla``."""
        if rebuild_ell and self.ell is not None and self.ell.epos is not None:
            w_real = weight[:self.n_edges]
            return replace(self, weight=weight, rev_weight=rev_weight,
                           ell=ell_reweight(self.ell, w_real),
                           rev_ell=ell_reweight(self.rev_ell, w_real))
        return replace(self, weight=weight, rev_weight=rev_weight,
                       impl="xla" if self.impl == "ell" else self.impl,
                       ell=None, rev_ell=None)


def build_graph(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
                n_nodes: int, n_src_nodes: int | None = None, *,
                device: torch.device | str,
                with_reverse: bool = True, with_pallas: bool = False,
                impl: str = "pallas", precision: str = "f32x2",
                with_ell: bool | None = None) -> Graph:
    """Host-side constructor: sorts edges by dst (stable), builds the
    row pointer and, with ``with_reverse``, the transposed ordering.
    With ``with_pallas`` the edge list is padded to the TPU kernel's
    segment layout (``pad_edges``), so the padded arrays equal the JAX
    package's element for element.

    With ``with_ell`` (default: when ``impl`` is ``ell``) and
    ``with_reverse`` the bucketed-ELL layouts are built from the real
    edges, as the JAX package's ``build_graph`` builds them: forward
    reduces by dst and gathers by src; the transpose is re-sorted by
    src and records its slots' edge ids in the canonical dst-sorted
    order, so ``with_weight(..., rebuild_ell=True)`` can re-weight
    both."""
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
    if with_ell is None:
        with_ell = impl == "ell"
    if with_ell and with_reverse:
        s, d, w = src[:nnz], dst[:nnz], weight[:nnz]
        g.ell = build_ell(s, d, w, n_nodes, with_epos=True, device=device)
        r_order = np.argsort(s, kind="stable")
        g.rev_ell = build_ell(d[r_order], s[r_order], w[r_order],
                              n_src_nodes, with_epos=True, edge_ids=r_order,
                              device=device)
    if with_reverse:
        rev_order = np.argsort(src, kind="stable").astype(np.int32)
        rev_dst = src[rev_order]
        g.rev_src = t(dst[rev_order])
        g.rev_dst = t(rev_dst)
        g.rev_edge_id = t(rev_order)
        g.rev_weight = t(weight[rev_order])
        g.rev_rowptr = t(build_rowptr(rev_dst, n_src_nodes))
    return g


def graph_impl(impl: str, with_segment_layout: bool) -> str:
    """The impl a graph built with or without the segment layout
    (``with_pallas``) runs, as the JAX package dispatches per graph
    (``recbole_gnn_tpu/ops/spmm.py:375-386``): ``pallas`` runs the
    streaming kernel only on a graph that has the segment layout, and
    the XLA segment sum (the port's ``xla``) on one without."""
    if impl == "pallas" and not with_segment_layout:
        return "xla"
    return impl


def _check_cuda_impl(graph: Graph):
    """Refuse, on the card, an impl or precision that has no kernel (a
    graph whose fields were set past ``build_graph``'s checks)."""
    if graph.impl not in SPMM_IMPLS:
        raise NotImplementedError(
            f"sparse_spmm_impl={graph.impl!r} has no CUDA kernel; use one "
            f"of {SPMM_IMPLS}")
    if graph.impl == "pallas" and graph.precision not in SPMM_PRECISIONS:
        raise NotImplementedError(
            f"pallas_spmm_precision={graph.precision!r} has no CUDA kernel; "
            f"use one of {SPMM_PRECISIONS}")


def xla_spmm(src: torch.Tensor, dst: torch.Tensor, weight: torch.Tensor,
             rowptr: torch.Tensor, x: torch.Tensor,
             chunk: int | None = None) -> torch.Tensor:
    """out[r] = Σ_{e ∈ [rowptr[r], rowptr[r+1])} weight[e]·x[src[e]] as
    ``sparse_spmm_impl: xla`` computes it: the messages ``x[src]`` by
    :func:`row_gather`, then the sorted sum of ``weight[e]·msgs[e]`` by
    :func:`block_segment_sum` (f32 mode with the weight, each product
    rounded once, as JAX's ``x[src] * w``) into ``len(rowptr) - 1``
    rows.

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
        # the (c, D) message array is the peak; D1 reads it once, with
        # the weight, and writes only the output
        msgs = row_gather(x, src[s:s + c])
        rp = rowptr if c == e else rowptr.clamp(s, s + c) - s
        out = block_segment_sum(msgs, dst[s:s + c], rp, "f32", out=out,
                                weight=weight[s:s + c])
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


class EllSpmmFunction(torch.autograd.Function):
    """Differentiable ``ell`` SpMM over a graph with both layouts — the
    port of ``_spmm_core`` with ELL selected
    (``recbole_gnn_tpu/ops/spmm.py:305-307, 336-338``).

    ``apply(x, weight, graph, weight_grad)``: forward
    :func:`ell_spmm` over ``graph.ell`` (its weights baked in; ``weight``
    is passed for autograd); the x-cotangent is the same kernel over
    ``graph.rev_ell`` (:func:`ell_spmm_transpose`); the weight
    cotangent as in ``SegmentSpmmFunction``."""

    @staticmethod
    def forward(ctx, x, weight, graph, weight_grad):
        ctx.graph = graph
        ctx.weight_grad = bool(weight_grad)
        ctx.save_for_backward(x if ctx.weight_grad else None)
        return ell_spmm(graph.ell, x)

    @staticmethod
    def backward(ctx, g):
        graph = ctx.graph
        (x,) = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = ell_spmm_transpose(graph.rev_ell, g)
        if ctx.weight_grad and ctx.needs_input_grad[1]:
            gw = weight_cotangent(graph, x, g)
        return gx, gw, None, None


def spmm(graph: Graph, x: torch.Tensor,
         weight_grad: bool = False) -> torch.Tensor:
    """SpMM over a :class:`Graph` → (graph.n_nodes, D), differentiable.

    CUDA: the kernels of ``graph.impl`` (``ell``: the bucketed-ELL SpMM;
    ``pallas``: the segment SpMM in the graph's precision; ``xla``: row
    gather + block segment sum) or a raise, forward and backward; an
    ``ell`` graph without its layouts runs ``xla``.  CPU: ``ell`` with
    its layouts and ``xla`` run their kernels' plain versions,
    ``pallas`` the plain ``spmm_coo``.  The x-gradient is the transpose
    SpMM over the transpose layout or the reverse CSR.

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
        if graph.impl in ("xla", "ell"):
            return xla_spmm(graph.src, graph.dst, graph.weight,
                            graph.rowptr, x)
        return segment_spmm(graph.src, graph.dst, graph.weight,
                            graph.rowptr, x, graph.precision)
    if graph.impl == "ell" and graph.ell is not None \
            and graph.rev_ell is not None:
        return EllSpmmFunction.apply(x, graph.weight, graph, weight_grad)
    if graph.impl in ("xla", "ell"):
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


def dense_dtype(a: torch.Tensor, x: torch.Tensor) -> torch.dtype:
    """The dtype of a dense product ``a·x`` as the JAX package's
    ``jnp.dot(a, x, preferred_element_type=f32)`` gives it: the promoted
    type of the two, and f32 where both are bf16 (f32 ``a`` with a bf16
    ``x`` is f32; so is a bf16 ``a`` with a bf16 ``x``)."""
    dt = torch.promote_types(a.dtype, x.dtype)
    return torch.float32 if dt == torch.bfloat16 else dt


def _dense_product(a: torch.Tensor, x: torch.Tensor, n_users: int
                   ) -> torch.Tensor:
    """U←A·I and I←Aᵀ·U in :func:`dense_dtype`: both operands widened
    to it (exact from bf16), so the products sum in f32 as JAX's
    ``preferred_element_type=f32`` does."""
    dt = dense_dtype(a, x)
    a, x = a.to(dt), x.to(dt)
    xu, xi = x[:n_users], x[n_users:]
    return torch.cat([torch.matmul(a, xi), torch.matmul(a.T, xu)], dim=0)


def spmm_dense_bipartite(graph: BipartiteDenseGraph,
                         x: torch.Tensor) -> torch.Tensor:
    """Two dense products (U←A·I, I←Aᵀ·U), left to cuBLAS as the JAX
    package leaves them to XLA, in the promoted dtype
    (:func:`dense_dtype`): a bf16 ``x`` or a bf16-stored ``a`` gives an
    f32 output, as JAX's ``jnp.dot`` with ``preferred_element_type=f32``
    does; neither operand is narrowed."""
    return _dense_product(graph.a, x, graph.n_users)


def dense_dropout_masks(gen: torch.Generator, graph: BipartiteDenseGraph,
                        drop_p: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The two keep-masks of :func:`spmm_dense_bipartite_dropout`, one
    per direction, each Bernoulli(1 − drop_p) over the block."""
    shape = tuple(graph.a.shape)
    return tuple(torch.rand(shape, generator=gen, device=gen.device)
                 < 1.0 - drop_p for _ in range(2))


def spmm_dense_bipartite_dropout(graph: BipartiteDenseGraph, x: torch.Tensor,
                                 masks: tuple[torch.Tensor, torch.Tensor]
                                 ) -> torch.Tensor:
    """Dense propagation with per-direction edge dropout and no rescale
    (PyG ``dropout_adj`` on the COO path: each direction dropped
    independently, weights kept): U ← (m₁ ⊙ A)·I, I ← (m₂ ⊙ A)ᵀ·U, with
    ``masks`` from :func:`dense_dropout_masks`; in the promoted dtype
    as :func:`spmm_dense_bipartite`."""
    dt = dense_dtype(graph.a, x)
    a, x = graph.a.to(dt), x.to(dt)
    zero = torch.zeros((), dtype=dt, device=a.device)
    a1 = torch.where(masks[0], a, zero)
    a2 = torch.where(masks[1], a, zero)
    xu, xi = x[:graph.n_users], x[graph.n_users:]
    return torch.cat([torch.matmul(a1, xi), torch.matmul(a2.T, xu)], dim=0)


def spmm_any(graph, x: torch.Tensor) -> torch.Tensor:
    """Dispatch over graph representations (dense bipartite | COO |
    edge-sharded ELL)."""
    if isinstance(graph, BipartiteDenseGraph):
        return spmm_dense_bipartite(graph, x)
    # imported here: parallel/sharded_spmm builds on ops/ell_spmm
    from recbole_gnn_tpu_torch.parallel.sharded_spmm import (
        ShardedEll, sharded_ell_spmm)
    if isinstance(graph, ShardedEll):
        return sharded_ell_spmm(graph, x)
    return spmm(graph, x)


def matvec_any(m, x: torch.Tensor) -> torch.Tensor:
    """``m @ x`` over either representation of a (possibly rectangular)
    matrix: a dense tensor (a cuBLAS matmul) or a sparse :class:`Graph`
    (:func:`spmm`, whose dst indexes rows and src columns)."""
    if isinstance(m, Graph):
        return spmm(m, x)
    return torch.matmul(m, x)
