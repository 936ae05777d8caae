"""Loss library — BPR, EmbLoss, the InfoNCE variants, DirectAU's
alignment / uniformity and the sequential family's full-catalog cross
entropy (port of ``recbole_gnn_tpu/models/losses.py``).

Semantics match the [recbole] losses the reference imports: BPRLoss
with gamma = 1e-10, EmbLoss with its ``require_pow`` branch; the
pairwise losses take an optional per-row ``weight`` so that the
weight-0 rows the loaders pad the last batch with contribute nothing.
``masked_unique`` / ``cl_nce_masked`` are SimGCL's and XSimGCL's
contrastive loss over a batch's unique ids; ``info_nce`` takes its
negatives from a whole table (SGL, NCL): on the card through the
streaming kernel pair of ``ops/nce.py``, on the CPU through a chunked
logsumexp when the (B, n) logits would exceed ``_NCE_CHUNK_ENTRIES``
entries.

Under data parallelism (``parallel/comm.batch_reduction``) each rank
holds a slice of the batch and every loss here is the global batch's:
batch sums are all-reduced over the data-parallel ranks before a mean,
a square root or a divide (BPR's Σw, EmbLoss's Σe²), and the in-batch
losses gather the batch's rows (or ids) from every rank first.
"""

from __future__ import annotations

import torch

from recbole_gnn_tpu_torch.models.init import l2_normalize as _l2n
from recbole_gnn_tpu_torch.ops import nce
from recbole_gnn_tpu_torch.parallel.comm import (batch_gather,
                                                 batch_gather_ids,
                                                 batch_mean, batch_reducing,
                                                 batch_sum)
from recbole_gnn_tpu_torch.utils import trace

# (B, n) InfoNCE denominators on the CPU above this many entries stream
# through :func:`_chunked_lse` instead of materialising the logits
# (SGL's all-node negatives at web scale would otherwise build a
# B × 1.1M buffer); the JAX package's threshold
_NCE_CHUNK_ENTRIES = nce.CHUNK_ENTRIES


def _wmean(x: torch.Tensor, weight: torch.Tensor | None,
           over_ranks: bool = True) -> torch.Tensor:
    """Weighted mean over the batch rows; ``over_ranks``: over the
    global batch (this rank's rows are a slice of it)."""
    red = batch_sum if over_ranks else (lambda t: t)
    if weight is None:
        return batch_mean(x) if over_ranks else x.mean()
    return red((x * weight).sum()) / torch.clamp(red(weight.sum()), min=1.0)


def _wsum(x: torch.Tensor, weight: torch.Tensor | None,
          over_ranks: bool = True) -> torch.Tensor:
    red = batch_sum if over_ranks else (lambda t: t)
    if weight is None:
        return red(x.sum())
    return red((x * weight).sum())


def bpr_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
             weight: torch.Tensor | None = None,
             gamma: float = 1e-10) -> torch.Tensor:
    """-log(gamma + sigmoid(pos - neg)), mean ([recbole] BPRLoss).

    Not ``F.logsigmoid``: the gamma floor caps the loss at ~23 for
    large negative margins, where logsigmoid keeps growing."""
    return _wmean(-torch.log(gamma + torch.sigmoid(pos_scores - neg_scores)),
                  weight)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  weight: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over full-catalog logits (the sequential family's
    default loss)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, targets[:, None])[:, 0]
    return _wmean(nll, weight)


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
        batch_size = torch.clamp(batch_sum(weight.sum()), min=1.0)
    elif batch_reducing():
        batch_size = batch_sum(embeddings[0].new_tensor(float(batch_size)))
    total = 0.0
    for e in embeddings:
        if weight is not None:
            e = e * weight.reshape((-1,) + (1,) * (e.dim() - 1))
        if require_pow:
            total = total + (e.abs() ** norm).sum()
        else:
            total = total + torch.sqrt(torch.clamp(batch_sum((e * e).sum()),
                                                   min=1e-24))
    if require_pow:
        total = batch_sum(total / norm)
    return total / batch_size


def reg_loss_l2(params_leaves: list[torch.Tensor]) -> torch.Tensor:
    """Plain Σ‖W‖₂² over parameter tensors."""
    return sum((p * p).sum() for p in params_leaves)


def masked_unique(ids: torch.Tensor, size: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the sorted unique ids padded with 0 to ``size``, the mask
    ``u > 0``): ``jnp.unique(ids, size=size, fill_value=0)`` with id 0
    (PAD, never a batch's real id) marking the fill slots."""
    ids = batch_gather_ids(ids)      # the global batch's ids
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


def _chunked_lse(v1: torch.Tensor, av2: torch.Tensor, tau: float
                 ) -> torch.Tensor:
    """The plain version's chunked logsumexp at this module's threshold
    (``ops/nce.py::chunked_lse``)."""
    return nce.chunked_lse(v1, av2, tau, _NCE_CHUNK_ENTRIES)


def info_nce(view1: torch.Tensor, view2: torch.Tensor, temperature: float,
             weight: torch.Tensor | None = None,
             all_view2: torch.Tensor | None = None,
             reduction: str = "sum") -> torch.Tensor:
    """InfoNCE between aligned rows of two views: the positive is
    cos(view1ᵢ, view2ᵢ), the negatives every row of ``all_view2``
    (default view2: the global batch's rows), all L2-normalised inside;
    'sum' (SGL, NCL) or weighted 'mean'.  The logsumexp over the
    negatives runs the kernel pair on a card (``ops/nce.py::nce_lse``)
    and the plain version on the CPU; counters ``nce_calls`` (every
    call, here) and ``nce_kernel`` (calls served by the kernel, counted
    at its launch) go to the innermost open span
    (``utils/trace.py``)."""
    in_batch = all_view2 is None
    if in_batch:
        view1, view2 = batch_gather(view1), batch_gather(view2)
        weight = None if weight is None else batch_gather(weight)
    v1 = _l2n(view1)
    v2 = _l2n(view2)
    av2 = v2 if all_view2 is None else _l2n(all_view2)
    pos = (v1 * v2).sum(-1) / temperature
    if v1.device.type == "cpu" and \
            v1.shape[0] * av2.shape[0] > _NCE_CHUNK_ENTRIES:
        lse = _chunked_lse(v1, av2, temperature)
    else:
        lse = nce.nce_lse(v1, av2, temperature)
    trace.count("nce_calls", 1)
    loss = lse - pos
    if reduction == "sum":
        return _wsum(loss, weight, over_ranks=not in_batch)
    return _wmean(loss, weight, over_ranks=not in_batch)


def batch_softmax_loss(user_emb: torch.Tensor, item_emb: torch.Tensor,
                       temperature: float,
                       weight: torch.Tensor | None = None) -> torch.Tensor:
    """In-batch sampled softmax (SSL4REC's rec loss): positives on the
    diagonal, the global batch's other (unpadded) items as negatives."""
    user_emb, item_emb = batch_gather(user_emb), batch_gather(item_emb)
    weight = None if weight is None else batch_gather(weight)
    u = _l2n(user_emb)
    i = _l2n(item_emb)
    pos = (u * i).sum(-1) / temperature
    logits = torch.matmul(u, i.T) / temperature
    if weight is not None:
        logits = logits.masked_fill(~(weight[None, :] > 0), float("-inf"))
    loss = torch.logsumexp(logits, dim=-1) - pos
    return _wmean(loss, weight, over_ranks=False)


def alignment_loss(x: torch.Tensor, y: torch.Tensor,
                   weight: torch.Tensor | None = None,
                   alpha: int = 2) -> torch.Tensor:
    """DirectAU alignment: mean ‖x − y‖₂^α over the pairs."""
    d = torch.sqrt(torch.clamp(((x - y) ** 2).sum(-1), min=1e-24)) ** alpha
    return _wmean(d, weight)


def uniformity_loss(x: torch.Tensor, weight: torch.Tensor | None = None,
                    t: float = 2.0) -> torch.Tensor:
    """DirectAU uniformity: log mean exp(−t·‖xᵢ − xⱼ‖²) over the pairs
    i < j (``torch.pdist``'s pairs), the squared distances as
    ‖xᵢ‖² + ‖xⱼ‖² − 2xᵢ·xⱼ clamped at 0, as the JAX package forms them;
    the pairs of the global batch."""
    x = batch_gather(x)
    weight = None if weight is None else batch_gather(weight)
    sq = (x * x).sum(-1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * torch.matmul(x, x.T),
                     min=0.0)
    iu = torch.triu_indices(x.shape[0], x.shape[0], offset=1,
                            device=x.device)
    vals = torch.exp(-t * d2[iu[0], iu[1]])
    if weight is not None:
        wpair = weight[iu[0]] * weight[iu[1]]
        mean = (vals * wpair).sum() / torch.clamp(wpair.sum(), min=1.0)
    else:
        mean = vals.mean()
    return torch.log(torch.clamp(mean, min=1e-24))
