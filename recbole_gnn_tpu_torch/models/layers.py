"""Reusable GNN layers (port of the general models' part of
``recbole_gnn_tpu/models/layers.py``: the LightGCN conv and NGCF's
bi-interaction conv) and the inverted dropout the models share."""

from __future__ import annotations

import torch

from recbole_gnn_tpu_torch.models.init import linear, linear_params, split_keys
from recbole_gnn_tpu_torch.ops.spmm import spmm, spmm_any


def lightgcn_conv(graph, x: torch.Tensor) -> torch.Tensor:
    """Weighted add-aggregation over the normalised adjacency: one SpMM
    (dense or sparse per the graph's representation)."""
    return spmm_any(graph, x)


def lightgcn_propagate(graph, ego: torch.Tensor, n_layers: int,
                       include_ego: bool = True) -> list[torch.Tensor]:
    """K propagation steps; returns the per-layer embedding list
    [e⁰, e¹, …, e^K] (models differ in how they combine them)."""
    out = [ego] if include_ego else []
    h = ego
    for _ in range(n_layers):
        h = lightgcn_conv(graph, h)
        out.append(h)
    return out


def bignn_params(gen: torch.Generator, d_in: int, d_out: int, *,
                 device: torch.device | str = "cpu") -> dict:
    k1, k2 = split_keys(gen, 2)
    return {"lin1": linear_params(k1, d_in, d_out, device=device),
            "lin2": linear_params(k2, d_in, d_out, device=device)}


def bignn_conv(p: dict, graph, x: torch.Tensor) -> torch.Tensor:
    """(L + I)·E·W₁ + (L·E ⊙ E)·W₂ over a sparse :class:`Graph`."""
    x_prop = spmm(graph, x)
    return linear(p["lin1"], x_prop + x) + linear(p["lin2"], x_prop * x)


def dropout_keep(gen: torch.Generator, shape, p: float) -> torch.Tensor:
    """Bernoulli(1 − p) keep-mask (``jax.random.bernoulli``'s u < 1 − p)."""
    return torch.rand(shape, generator=gen, device=gen.device) < 1.0 - p


def apply_dropout(x: torch.Tensor, keep: torch.Tensor, p: float
                  ) -> torch.Tensor:
    """Inverted dropout with a given keep-mask: x / (1 − p) or 0."""
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
