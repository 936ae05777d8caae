"""Parameter initializers (port of ``recbole_gnn_tpu/models/init.py``,
the part the ported models use: ``xavier_uniform`` for LightGCN,
``xavier_normal`` for BPR).

Params are plain dicts of tensors, as in the JAX package, so the same
numpy arrays can feed both.  Draws come from an explicit
``torch.Generator`` and are moved to ``device`` afterwards, so a CPU
generator gives the same params on every device.
"""

from __future__ import annotations

import math

import torch


def xavier_uniform(gen: torch.Generator, shape: tuple[int, ...], *,
                   device: torch.device | str = "cpu",
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    t = torch.empty(shape, dtype=dtype, device=gen.device)
    t.uniform_(-limit, limit, generator=gen)
    return t.to(device)


def xavier_normal(gen: torch.Generator, shape: tuple[int, ...], *,
                  device: torch.device | str = "cpu",
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    std = math.sqrt(2.0 / (fan_in + fan_out))
    t = torch.empty(shape, dtype=dtype, device=gen.device)
    t.normal_(0.0, std, generator=gen)
    return t.to(device)
