"""Distributed full-catalog top-k — the port of K7's
``distributed_full_sort_topk``.

Port of ``recbole_gnn_tpu/parallel/topk.py``: the item table is split
by rows over the ranks of a group; each rank scores the users against
its block (one f32 product, cuBLAS on the card), masks its slice of
each user's history and the pad rows past the real catalog, takes the
local top-k (``torch.topk``), and the (B, k) candidate values and
global ids — not the scores — are all-gathered and cut to the top-k of
their union.  The global top-k always lies in that union.  Neither the
(B, n_items) score matrix nor a (B, n_items) mask exists on one rank.
"""

from __future__ import annotations

import torch

from recbole_gnn_tpu_torch.ops.topk import NEG_INF, masked_topk
from recbole_gnn_tpu_torch.parallel.comm import (all_gather_cat, group_rank,
                                                 group_size)


def distributed_full_sort_topk(user_emb: torch.Tensor,
                               item_shard: torch.Tensor,
                               history: torch.Tensor, k: int, group,
                               n_valid_items: int | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, global item ids), each (B, k), of the top-k over every
    rank's block of the catalog.

    Args:
      user_emb: (B, D), the same on every rank of ``group``.
      item_shard: (n_items / n_shards, D), this rank's row block of the
        catalog (pad the catalog with PAD rows to the shard multiple).
      history: (B, H) int — item ids to exclude (include id 0 to drop
        the PAD item); ids outside this rank's block are dropped here.
      k: cut (at most the block's rows).
      group: the process group the blocks lie over (None: one block).
      n_valid_items: real catalog size; rows at and past it (the pad to
        the shard multiple) are masked on every rank.

    ``distributed_full_sort_topk.launches`` counts the calls.
    """
    distributed_full_sort_topk.launches += 1
    shard_size = item_shard.shape[0]
    if k > shard_size:
        raise ValueError(f"k={k} exceeds the {shard_size} rows of a shard")
    sid = group_rank(group)
    n_items = shard_size * group_size(group)
    n_valid = n_items if n_valid_items is None else int(n_valid_items)
    b = user_emb.shape[0]
    scores = torch.matmul(user_emb.float(), item_shard.float().T)
    # out-of-shard ids → the sentinel column past the block (dropped)
    h = history.long() - sid * shard_size
    h = torch.where((h >= 0) & (h < shard_size), h,
                    torch.full_like(h, shard_size))
    scores = torch.cat([scores, scores.new_zeros((b, 1))], dim=1)
    scores.scatter_(1, h, NEG_INF)
    scores = scores[:, :shard_size]
    if n_valid < n_items:
        col = sid * shard_size + torch.arange(shard_size,
                                              device=scores.device)
        scores = scores.masked_fill((col >= n_valid)[None, :], NEG_INF)
    v, idx = masked_topk(scores, k)
    gidx = idx + sid * shard_size
    # the small candidate sets, in rank order along the last axis
    v_cat = all_gather_cat(v, group, dim=1)
    g_cat = all_gather_cat(gidx, group, dim=1)
    vm, im = masked_topk(v_cat, k)
    return vm, torch.gather(g_cat, 1, im)


distributed_full_sort_topk.launches = 0


def item_shard(item_table: torch.Tensor, group) -> torch.Tensor:
    """This rank's row block of the catalog over ``group``: the table
    padded with PAD (zero) rows to the shard multiple, then cut into
    equal blocks in group-rank order."""
    shards = group_size(group)
    per = -(-item_table.shape[0] // shards)
    pad = per * shards - item_table.shape[0]
    if pad:
        item_table = torch.cat([item_table, item_table.new_zeros(
            (pad, item_table.shape[1]))])
    lo = group_rank(group) * per
    return item_table[lo:lo + per]
