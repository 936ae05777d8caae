"""Segment reductions (K5): sum, mean, max and softmax per segment.

Port of ``recbole_gnn_tpu/ops/segment.py`` on PyTorch's built-ins
(``index_add_`` and ``scatter_reduce``), the counterparts of
``jax.ops.segment_*``; ``segment_ids`` need not be sorted
(``indices_are_sorted`` is accepted for the JAX signature and changes
nothing).  Empty segments give 0 for the sum and the mean and −inf for
the max; in the softmax a masked entry gets probability 0 and adds
nothing to its segment's normaliser, and a segment with no unmasked
entry gives zeros, not NaN.
"""

from __future__ import annotations

import torch


def _rows(n: int, like: torch.Tensor) -> torch.Tensor:
    return like.new_zeros((n,) + tuple(like.shape[1:]))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                indices_are_sorted: bool = False) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets by ``segment_ids``."""
    return _rows(num_segments, data).index_add(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 indices_are_sorted: bool = False) -> torch.Tensor:
    """Mean of the rows per segment (empty segments → 0)."""
    totals = segment_sum(data, segment_ids, num_segments)
    counts = segment_sum(torch.ones(data.shape[:1], dtype=data.dtype,
                                    device=data.device),
                         segment_ids, num_segments).clamp_min(1)
    return totals / counts.reshape((-1,) + (1,) * (data.ndim - 1))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                indices_are_sorted: bool = False) -> torch.Tensor:
    """Max of the rows per segment (empty segments → −inf)."""
    idx = segment_ids.reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    init = torch.full((num_segments,) + tuple(data.shape[1:]), -torch.inf,
                      dtype=data.dtype, device=data.device)
    return init.scatter_reduce(0, idx, data, "amax", include_self=False)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, mask: torch.Tensor | None = None,
                    indices_are_sorted: bool = False) -> torch.Tensor:
    """Numerically stable softmax within each segment (PyG's
    ``softmax(alpha, index)`` / DGL's ``edge_softmax``).

    ``mask`` (bool per entry) leaves out padding: masked entries get
    probability 0 and add nothing to the normaliser.  The shift by the
    segment max does not change the value, so it carries no gradient."""
    if mask is not None:
        logits = torch.where(mask, logits, -torch.inf)
    maxes = segment_max(logits.detach(), segment_ids, num_segments)
    # empty / fully masked segments have a −inf max
    maxes = torch.where(torch.isfinite(maxes), maxes, 0.0)
    shifted = logits - maxes[segment_ids]
    finite = torch.isfinite(shifted)
    exp = torch.where(finite, torch.exp(torch.where(finite, shifted, 0.0)),
                      0.0)
    denom = segment_sum(exp, segment_ids, num_segments).clamp_min(1e-16)
    return exp / denom[segment_ids]


__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_softmax"]
