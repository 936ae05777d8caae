"""Graph normalisation and augmentation (K6: port of
``recbole_gnn_tpu/ops/graphops.py``).

Degrees are ``index_add_`` of 0/1 values, exact in any order, so the
atomic adds on the card give the JAX package's numbers.  Dropout keeps
the edge count static: a keep-mask zeroes weights and the caller
re-normalises with the mask (``sym_norm_weights`` / ``row_norm_weights``)
instead of resizing the edge list.  Masks are drawn from an explicit
``torch.Generator`` on the edges' device.
"""

from __future__ import annotations

import torch


def degree(index: torch.Tensor, n_nodes: int,
           weight: torch.Tensor | None = None) -> torch.Tensor:
    """(Weighted) node degree from an edge endpoint array, f32."""
    if weight is None:
        weight = torch.ones(index.shape, dtype=torch.float32,
                            device=index.device)
    return torch.zeros(n_nodes, dtype=weight.dtype,
                       device=index.device).index_add_(0, index.long(),
                                                       weight)


def _deg_masked(src, dst, n_nodes, mask):
    ones = torch.ones(src.shape, dtype=torch.float32, device=src.device)
    if mask is not None:
        ones = ones * mask.to(torch.float32)
    return degree(dst, n_nodes, ones)


def sym_norm_weights(src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """D^{-1/2} A D^{-1/2} edge weights (PyG ``gcn_norm`` without self
    loops), degrees taken over ``dst``; masked edges weigh 0 and count
    in no degree."""
    deg = _deg_masked(src, dst, n_nodes, mask)
    dis = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)),
                      torch.zeros_like(deg))
    w = dis[src.long()] * dis[dst.long()]
    if mask is not None:
        w = w * mask.to(torch.float32)
    return w


def row_norm_weights(src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """D^{-1} A edge weights (1 / in-degree of dst)."""
    deg = _deg_masked(src, dst, n_nodes, mask)
    dinv = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1e-12),
                       torch.zeros_like(deg))
    w = dinv[dst.long()]
    if mask is not None:
        w = w * mask.to(torch.float32)
    return w


def edge_dropout_mask(gen: torch.Generator, n_edges: int,
                      drop_ratio: float) -> torch.Tensor:
    """Bool keep-mask over edges (uniform ≥ drop_ratio), on the
    generator's device."""
    return torch.rand(n_edges, generator=gen, device=gen.device) >= drop_ratio


def node_dropout_edge_mask(gen: torch.Generator, src: torch.Tensor,
                           dst: torch.Tensor, n_nodes: int,
                           drop_ratio: float) -> torch.Tensor:
    """Bool keep-mask over edges induced by dropping nodes: an edge
    stays when both its ends do."""
    keep = torch.rand(n_nodes, generator=gen, device=gen.device) >= drop_ratio
    return keep[src.long()] & keep[dst.long()]
