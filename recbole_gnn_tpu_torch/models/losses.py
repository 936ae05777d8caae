"""Loss library — BPR and EmbLoss (port of the part of
``recbole_gnn_tpu/models/losses.py`` the general pairwise models use).

Semantics match the [recbole] losses the reference imports: BPRLoss
with gamma = 1e-10, EmbLoss with its ``require_pow`` branch.  Every
loss takes an optional per-row ``weight`` so that the weight-0 rows the
loaders pad the last batch with contribute nothing.
"""

from __future__ import annotations

import torch


def _wmean(x: torch.Tensor, weight: torch.Tensor | None) -> torch.Tensor:
    if weight is None:
        return x.mean()
    return (x * weight).sum() / torch.clamp(weight.sum(), min=1.0)


def _wsum(x: torch.Tensor, weight: torch.Tensor | None) -> torch.Tensor:
    if weight is None:
        return x.sum()
    return (x * weight).sum()


def bpr_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
             weight: torch.Tensor | None = None,
             gamma: float = 1e-10) -> torch.Tensor:
    """-log(gamma + sigmoid(pos - neg)), mean ([recbole] BPRLoss).

    Not ``F.logsigmoid``: the gamma floor caps the loss at ~23 for
    large negative margins, where logsigmoid keeps growing."""
    return _wmean(-torch.log(gamma + torch.sigmoid(pos_scores - neg_scores)),
                  weight)


def emb_loss(embeddings: list[torch.Tensor],
             batch_size: int | torch.Tensor, require_pow: bool = False,
             norm: int = 2,
             weight: torch.Tensor | None = None) -> torch.Tensor:
    """[recbole] EmbLoss: Σ‖e‖ₚ / B, or with require_pow Σ‖e‖ₚᵖ / p / B.

    Without ``require_pow`` each norm is taken over the whole gathered
    block, ``sqrt(max(Σe², 1e-24))``.  ``weight`` zeroes padded rows
    inside each embedding (rows are the batch axis) and makes the batch
    size ``max(Σw, 1)``."""
    if weight is not None:
        batch_size = torch.clamp(weight.sum(), min=1.0)
    total = 0.0
    for e in embeddings:
        if weight is not None:
            e = e * weight.reshape((-1,) + (1,) * (e.dim() - 1))
        if require_pow:
            total = total + (e.abs() ** norm).sum()
        else:
            total = total + torch.sqrt(torch.clamp((e * e).sum(), min=1e-24))
    if require_pow:
        total = total / norm
    return total / batch_size


def reg_loss_l2(params_leaves: list[torch.Tensor]) -> torch.Tensor:
    """Plain Σ‖W‖₂² over parameter tensors."""
    return sum((p * p).sum() for p in params_leaves)
