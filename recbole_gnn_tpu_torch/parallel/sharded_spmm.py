"""Edge-sharded SpMM — the port of K7's ``sharded_ell_spmm``.

Port of ``recbole_gnn_tpu/parallel/sharded_spmm.py``: a graph too large
for one device's memory is cut by contiguous DESTINATION-node blocks of
``node_block = ceil(n / n_shards)`` nodes across a mesh axis.  Each
shard holds the port's bucketed-ELL layout (``ops/ell_spmm.EllMeta``)
of its edges in two directions:

  forward    reduce over the shard's dst block (``n_out = node_block``),
             gather from all ``n_src`` nodes of a replicated x — K2;
  transpose  reduce over the global src nodes, gather from the shard's
             block of the cotangent — K2ᵀ.

:class:`ShardedEllSpmmFunction` runs K2 over this rank's forward layout
and all-gathers the output blocks over the axis; its backward (the
adjoint) sums every rank's cotangent of the gathered output, keeps this
rank's block and runs K2ᵀ over the transpose layout.  The partial dx
that leaves it is this rank's edges' share: the trainer's gradient
reduction (``parallel/sharded_train.py``) sums the shares once, with
every other rank's contribution.

The per-rank work (:func:`shard_forward`, :func:`shard_transpose`) is
apart from the collectives, so every shard's local work can also run
in one process (``chip_smoke.py`` holds the summed shards against
unsharded K2/K2ᵀ on one card).

The JAX package pads every shard to one bucket grid because
``shard_map`` needs uniform shapes; here each shard's layout is built
at its own shape (the same sums in another order).  Node blocks are
equal-size, so a power-law graph's edges can fall unevenly across dst
blocks — a known limit, fine for id-ordered catalogs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from recbole_gnn_tpu_torch.ops.ell_spmm import (K_CAP, EllMeta, build_ell,
                                                ell_spmm, ell_spmm_transpose)
from recbole_gnn_tpu_torch.parallel.comm import (all_gather_cat, all_reduce_,
                                                 group_rank, group_size)


@dataclass
class EllShard:
    """One shard's layouts: ``fwd`` reduces over the local dst block and
    gathers global src ids; ``rev`` reduces over the global src nodes
    and gathers local dst ids."""

    fwd: EllMeta
    rev: EllMeta
    n_edges: int


@dataclass
class ShardedEll:
    """Edge-sharded graph: the shards this process holds (its own, or
    every shard for in-process use), the block geometry, and the group
    of the mesh axis the shards lie along (None: a group of one)."""

    shards: dict[int, EllShard]
    node_block: int
    n_nodes: int
    n_src_nodes: int
    n_shards: int
    group: object = None
    axis: str = "dp"

    @property
    def local(self) -> EllShard:
        """This rank's shard (its rank along the axis)."""
        return self.shards[group_rank(self.group)]

    @property
    def n_edges(self) -> int:
        """Real edges of the shards held here."""
        return sum(s.n_edges for s in self.shards.values())


def _shard_layouts(src, dst_local, w, node_block, n_src, k_cap, device
                   ) -> EllShard:
    order = np.argsort(dst_local, kind="stable")
    s, d, ww = src[order], dst_local[order], w[order]
    fwd = build_ell(s, d, ww, node_block, k_cap=k_cap, device=device)
    r = np.argsort(s, kind="stable")
    rev = build_ell(d[r], s[r], ww[r], n_src, k_cap=k_cap, device=device)
    return EllShard(fwd, rev, int(len(s)))


def build_sharded_ell(src, dst, w, n_nodes: int, n_shards: int,
                      n_src_nodes: int | None = None, group=None,
                      axis: str = "dp", shards=None, *,
                      device: torch.device | str = "cpu") -> ShardedEll:
    """Host build: the edges of each contiguous dst block of
    ``ceil(n_nodes / n_shards)`` nodes, in both directions.

    ``shards`` names the shard ids to build (default: this rank's along
    ``group``; with no group, every shard).  ``group`` is the process
    group of the mesh axis ``axis`` the shards lie along; it makes the
    result dispatch through ``ops.spmm.spmm_any``."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w, np.float32)
    n_nodes, n_shards = int(n_nodes), int(n_shards)
    n_src = int(n_src_nodes if n_src_nodes is not None else n_nodes)
    if group is not None and group_size(group) != n_shards:
        raise ValueError(f"{n_shards} shards over a group of "
                         f"{group_size(group)} ranks")
    node_block = -(-n_nodes // n_shards)
    if shards is None:
        shards = ([group_rank(group)] if group is not None
                  else range(n_shards))
    built = {}
    for sid in shards:
        lo = sid * node_block
        m = (dst >= lo) & (dst < lo + node_block)
        built[int(sid)] = _shard_layouts(src[m], dst[m] - lo, w[m],
                                         node_block, n_src, K_CAP, device)
    return ShardedEll(built, node_block, n_nodes, n_src, n_shards, group,
                      axis)


def shard_forward(shard: EllShard, x: torch.Tensor) -> torch.Tensor:
    """One shard's rows of A·x, (node_block, D): K2 over its forward
    layout."""
    return ell_spmm(shard.fwd, x)


def shard_transpose(shard: EllShard, g_block: torch.Tensor) -> torch.Tensor:
    """One shard's share of Aᵀ·g, (n_src, D), from its block of the
    cotangent: K2ᵀ over its transpose layout."""
    return ell_spmm_transpose(shard.rev, g_block)


class ShardedEllSpmmFunction(torch.autograd.Function):
    """``apply(x, meta)``: out = A·x over the edge-sharded layout,
    (n_nodes, D), the same on every rank of the axis.  Forward: K2 on
    this rank's block, then an all-gather of the blocks.  Backward (the
    adjoint): the all-reduce of every rank's cotangent, this rank's
    block of it, K2ᵀ — this rank's partial dx."""

    @staticmethod
    def forward(ctx, x, meta):
        ctx.meta = meta
        blk = shard_forward(meta.local, x.contiguous())
        return all_gather_cat(blk, meta.group)[:meta.n_nodes]

    @staticmethod
    def backward(ctx, g):
        meta = ctx.meta
        full = g.new_zeros((meta.node_block * meta.n_shards, g.shape[1]))
        full[:meta.n_nodes] = g
        all_reduce_(full, meta.group)
        lo = group_rank(meta.group) * meta.node_block
        return shard_transpose(meta.local,
                               full[lo:lo + meta.node_block]), None


def sharded_ell_spmm(meta: ShardedEll, x: torch.Tensor) -> torch.Tensor:
    """out = A·x over the edge-sharded layout; differentiable."""
    if meta.group is None and meta.n_shards != 1:
        raise ValueError("an edge-sharded graph of more than one shard "
                         "needs its mesh axis's process group")
    return ShardedEllSpmmFunction.apply(x, meta)
