"""Full-catalog scoring + exact top-k.

Port of ``recbole_gnn_tpu/ops/topk.py`` (``masked_topk``,
``full_sort_topk``, ``chunked_full_sort_topk``).  The JAX package routes large catalogs through
``approx_max_k(recall_target=1.0)``, which is exact, so ``torch.topk``
computes the same function.  Tie order may differ between the two.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float(np.float32(-1e30))


def masked_topk(scores: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """EXACT top-k over the last axis → (values, indices)."""
    vals, idx = torch.topk(scores, k, dim=-1, largest=True, sorted=True)
    return vals, idx


def full_sort_topk(user_emb: torch.Tensor, item_emb: torch.Tensor,
                   history_mask: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """scores = U @ Iᵀ with history masking, then top-k.

    Args:
      user_emb: (B, D) user vectors.
      item_emb: (n_items, D) full catalog.
      history_mask: (B, n_items) bool — True where the item must be
        excluded (already-interacted), per RecBole's -inf convention.
      k: cut.
    Returns (values (B,k), indices (B,k)).
    """
    scores = user_emb @ item_emb.T
    scores = scores.masked_fill(history_mask, NEG_INF)
    return masked_topk(scores, k)


def chunked_full_sort_topk(user_emb: torch.Tensor, item_emb: torch.Tensor,
                           history_mask: torch.Tensor, k: int,
                           chunk: int = 1024
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`full_sort_topk` over user chunks, so peak memory is
    chunk × n_items (the JAX package's ``lax.scan`` as a loop)."""
    n = user_emb.shape[0]
    if n == 0:
        return (user_emb.new_zeros((0, k)),
                torch.zeros((0, k), dtype=torch.int64, device=user_emb.device))
    parts = [full_sort_topk(user_emb[lo:lo + chunk], item_emb,
                            history_mask[lo:lo + chunk], k)
             for lo in range(0, n, chunk)]
    return (torch.cat([v for v, _ in parts]), torch.cat([i for _, i in parts]))
