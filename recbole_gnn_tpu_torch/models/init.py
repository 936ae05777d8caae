"""Parameter initializers and small functional NN helpers (port of
``recbole_gnn_tpu/models/init.py``).

Params are plain (nested) dicts and lists of tensors, as in the JAX
package, so the same numpy arrays can feed both.  Draws come from an
explicit ``torch.Generator`` and are moved to ``device`` afterwards, so
a CPU generator gives the same params on every device.
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


def uniform_pm(gen: torch.Generator, shape: tuple[int, ...], stdv: float, *,
               device: torch.device | str = "cpu",
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device=gen.device)
    t.uniform_(-stdv, stdv, generator=gen)
    return t.to(device)


def normal_init(gen: torch.Generator, shape: tuple[int, ...],
                std: float = 0.1, *, device: torch.device | str = "cpu",
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device=gen.device)
    t.normal_(0.0, std, generator=gen)
    return t.to(device)


def split_keys(gen: torch.Generator, n: int) -> list[torch.Generator]:
    """``n`` generators on ``gen``'s device, each seeded by a draw from
    ``gen`` (the counterpart of ``jax.random.split``)."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=gen,
                          device=gen.device).tolist()
    return [torch.Generator(device=gen.device).manual_seed(int(s))
            for s in seeds]


def linear_params(gen: torch.Generator, d_in: int, d_out: int,
                  init=xavier_uniform, bias: bool = True,
                  stdv: float | None = None, *,
                  device: torch.device | str = "cpu") -> dict:
    """{"w": (d_in, d_out)[, "b": (d_out,)]}: ``init`` weights and zero
    bias, or both uniform on ±``stdv`` when it is given."""
    kw, kb = split_keys(gen, 2)
    if stdv is not None:
        w = uniform_pm(kw, (d_in, d_out), stdv, device=device)
        b = uniform_pm(kb, (d_out,), stdv, device=device) if bias else None
    else:
        w = init(kw, (d_in, d_out), device=device)
        b = torch.zeros((d_out,), device=device) if bias else None
    p = {"w": w}
    if b is not None:
        p["b"] = b
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Smooth L2 row normalisation: x·rsqrt(Σx² + ε).

    Not x / max(‖x‖, ε): that has no finite gradient at x = 0, and the
    exact zero rows that propagation leaves (isolated PAD nodes) would
    send NaN through the norm's backward even where the value is
    masked."""
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)
