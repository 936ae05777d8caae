"""Loss library — BPR, EmbLoss and the masked InfoNCE (port of the part
of ``recbole_gnn_tpu/models/losses.py`` the general models ported so
far use).

Semantics match the [recbole] losses the reference imports: BPRLoss
with gamma = 1e-10, EmbLoss with its ``require_pow`` branch; the
pairwise losses take an optional per-row ``weight`` so that the
weight-0 rows the loaders pad the last batch with contribute nothing.
``masked_unique`` / ``cl_nce_masked`` are SimGCL's and XSimGCL's
contrastive loss over a batch's unique ids.
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


def _l2n(x: torch.Tensor) -> torch.Tensor:
    """Smooth L2 normalise: x / sqrt(Σx² + 1e-12), finite gradient at 0."""
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)


def masked_unique(ids: torch.Tensor, size: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the sorted unique ids padded with 0 to ``size``, the mask
    ``u > 0``): ``jnp.unique(ids, size=size, fill_value=0)`` with id 0
    (PAD, never a batch's real id) marking the fill slots."""
    size = ids.shape[0] if size is None else size
    uniq = torch.unique(ids, sorted=True)[:size]
    u = ids.new_zeros(size)
    u[:uniq.shape[0]] = uniq
    return u, u > 0


def cl_nce_masked(view1: torch.Tensor, view2: torch.Tensor,
                  temperature: float, mask: torch.Tensor,
                  reduction: str = "sum") -> torch.Tensor:
    """InfoNCE over masked rows: positives are aligned rows, negatives
    the other valid rows of view2; fill rows count in neither."""
    # the fill rows become ones BEFORE normalising: masking only the
    # value would leave a 0/0 in the norm's backward (NaN·0 = NaN)
    m = mask[:, None]
    v1 = _l2n(torch.where(m, view1, torch.ones_like(view1)))
    v2 = _l2n(torch.where(m, view2, torch.ones_like(view2)))
    pos = (v1 * v2).sum(-1) / temperature
    logits = torch.matmul(v1, v2.T) / temperature
    logits = torch.where(mask[None, :], logits,
                         torch.full_like(logits, -1e30))
    loss = torch.logsumexp(logits, dim=-1) - pos
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / torch.clamp(mask.sum().to(loss.dtype), min=1.0)
