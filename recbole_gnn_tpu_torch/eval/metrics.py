"""Ranking metrics @k — Recall / MRR / NDCG / Hit / Precision.

Port of ``recbole_gnn_tpu/eval/metrics.py`` on tensors:

  Hit@k        1 if any positive ranked in top-k
  Recall@k     |topk ∩ pos| / |pos|
  Precision@k  |topk ∩ pos| / k
  MRR@k        1 / rank of the first positive in top-k (0 if absent)
  NDCG@k       DCG@k / IDCG@k, binary relevance,
               DCG = Σ_{i: rel} 1/log2(i+1), ideal = min(|pos|, k) front-loaded

All computed from the top-k *indices* and per-user positive sets.
"""

from __future__ import annotations

import torch

METRIC_NAMES = ("recall", "mrr", "ndcg", "hit", "precision")


def relevance_at_k(topk_idx: torch.Tensor, pos_items: torch.Tensor,
                   pos_len: torch.Tensor) -> torch.Tensor:
    """(B, k) binary relevance: topk_idx[b, i] ∈ pos_items[b, :pos_len[b]].

    ``pos_items`` is a 0-padded (B, P) int tensor; index 0 is the PAD
    item and never appears in top-k (scorers mask it)."""
    cols = torch.arange(pos_items.shape[1], device=pos_items.device)
    pos = torch.where(cols[None, :] < pos_len[:, None], pos_items,
                      torch.full_like(pos_items, -1))
    return (topk_idx[:, :, None] == pos[:, None, :]).any(dim=-1)


def topk_metrics(topk_idx: torch.Tensor, pos_items: torch.Tensor,
                 pos_len: torch.Tensor, ks: tuple[int, ...]
                 ) -> dict[str, torch.Tensor]:
    """Per-user metric values for each cut in ``ks``:
    {f"{name}@{k}": (B,) float32}.  Users with pos_len == 0 contribute
    zeros."""
    dev = topk_idx.device
    rel = relevance_at_k(topk_idx, pos_items, pos_len).to(torch.float32)
    ranks = torch.arange(1, topk_idx.shape[1] + 1, dtype=torch.float32,
                         device=dev)
    discounts = 1.0 / torch.log2(ranks + 1.0)
    safe_len = torch.clamp(pos_len, min=1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)

    out: dict[str, torch.Tensor] = {}
    for k in ks:
        rel_k = rel[:, :k]
        hits_k = rel_k.sum(dim=1)
        out[f"recall@{k}"] = hits_k / safe_len
        out[f"hit@{k}"] = (hits_k > 0).to(torch.float32)
        out[f"precision@{k}"] = hits_k / float(k)
        # MRR: first relevant position (argmax returns the first maximum)
        first = torch.argmax(rel_k, dim=1)
        has = rel_k.amax(dim=1) > 0
        out[f"mrr@{k}"] = torch.where(has, 1.0 / (first + 1.0), zero)
        # NDCG with binary relevance
        dcg = (rel_k * discounts[None, :k]).sum(dim=1)
        ideal_len = torch.clamp(pos_len, max=k)
        cum = torch.cumsum(discounts[:k], dim=0)
        idcg = torch.where(ideal_len > 0,
                           cum[torch.clamp(ideal_len - 1, min=0)], one)
        out[f"ndcg@{k}"] = torch.where(pos_len > 0, dcg / idcg, zero)
    return out
