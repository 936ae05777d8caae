"""Lloyd's k-means (K6: port of ``recbole_gnn_tpu/ops/kmeans.py``), the
stand-in for the reference's faiss k-means in NCL's E-step.

Each iteration assigns every row to its nearest centroid by one matmul
and an argmin (‖x − c‖² = ‖x‖² − 2x·c + ‖c‖², ‖x‖² dropped), then sets
each centroid to the mean of its rows by ``index_add_``; an empty
cluster keeps its centroid.  A fixed number of iterations, from ``k``
distinct rows drawn from a generator (or given as ``init_idx``).
"""

from __future__ import annotations

import torch


def _assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    c_sq = (centroids * centroids).sum(-1)
    return torch.argmin(c_sq[None, :] - 2.0 * torch.matmul(x, centroids.T),
                        dim=-1)


def kmeans(gen: torch.Generator | None, x: torch.Tensor, k: int,
           n_iter: int = 20, init_idx: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(centroids (k, D), assignments (N,) int64) of ``x`` (N, D).
    ``init_idx``: the k starting rows; else ``k`` distinct rows from a
    permutation drawn from ``gen``."""
    n = x.shape[0]
    if init_idx is None:
        init_idx = torch.randperm(n, generator=gen, device=gen.device)[:k]
    centroids = x[init_idx.to(x.device).long()]
    ones = torch.ones(n, dtype=x.dtype, device=x.device)
    for _ in range(n_iter):
        assign = _assign(x, centroids)
        sums = torch.zeros_like(centroids).index_add_(0, assign, x)
        counts = torch.zeros(k, dtype=x.dtype,
                             device=x.device).index_add_(0, assign, ones)
        centroids = torch.where(counts[:, None] > 0,
                                sums / torch.clamp(counts[:, None], min=1.0),
                                centroids)
    return centroids, _assign(x, centroids)
