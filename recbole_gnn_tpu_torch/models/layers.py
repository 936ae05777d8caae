"""Reusable GNN layers (port of ``recbole_gnn_tpu/models/layers.py``;
``lightgcn_propagate`` so far)."""

from __future__ import annotations

import torch

from recbole_gnn_tpu_torch.ops.spmm import spmm_any


def lightgcn_propagate(graph, ego: torch.Tensor, n_layers: int,
                       include_ego: bool = True) -> list[torch.Tensor]:
    """K propagation steps; returns the per-layer embedding list
    [e⁰, e¹, …, e^K] (models differ in how they combine them)."""
    out = [ego] if include_ego else []
    h = ego
    for _ in range(n_layers):
        h = spmm_any(graph, h)
        out.append(h)
    return out
