"""Randomized low-rank SVD (K6: port of ``recbole_gnn_tpu/ops/svd.py``),
the stand-in for ``torch.svd_lowrank`` in LightGCL.

Halko et al.'s range finder with power iterations: products with the
operator, an SVD-based orthonormalisation of each sketch, and one exact
SVD of the small (q + p)-row core (``torch.linalg.svd``).  Every
product runs in full f32 (TF32 off for the call, restored after), as
the JAX package runs it at ``highest`` matmul precision: the reduced
precision loses the small singular directions the factorisation is
for.  The sparse form applies the COO matrix with ``index_add_``, so
the (m, n) matrix is never made dense.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch


@contextlib.contextmanager
def full_f32_matmul():
    """TF32 off for matmuls inside the block; the caller's settings are
    restored after."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(prec)


def _orth(x: torch.Tensor) -> torch.Tensor:
    # SVD-based: stays orthonormal when the sketch is rank-deficient
    return torch.linalg.svd(x, full_matrices=False)[0]


def randomized_svd(gen: torch.Generator | None,
                   matvec: Callable[[torch.Tensor], torch.Tensor],
                   rmatvec: Callable[[torch.Tensor], torch.Tensor],
                   m: int, n: int, q: int, n_oversample: int = 8,
                   n_power_iter: int = 2, *,
                   omega: torch.Tensor | None = None,
                   device: torch.device | str = "cpu"
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-q SVD of an (m, n) operator given A·X and Aᵀ·Y: (U (m, q),
    s (q,), V (n, q)) with A ≈ U diag(s) Vᵀ.  ``omega``: the (n, q + p)
    Gaussian sketch, else drawn from ``gen``."""
    r = q + n_oversample
    if omega is None:
        omega = torch.randn((n, r), generator=gen, device=gen.device)
    omega = omega.to(device=device, dtype=torch.float32)
    with full_f32_matmul():
        y = matvec(omega)
        for _ in range(n_power_iter):
            y = matvec(_orth(rmatvec(_orth(y))))
        qmat = _orth(y)                       # (m, r) range basis
        b = rmatvec(qmat).T                   # (r, n) = Qᵀ A
        u_small, s, vt = torch.linalg.svd(b, full_matrices=False)
        u = torch.matmul(qmat, u_small)
    return u[:, :q], s[:q], vt[:q].T


def randomized_svd_sparse(gen: torch.Generator | None, src: torch.Tensor,
                          dst: torch.Tensor, weight: torch.Tensor, m: int,
                          n: int, q: int, **kw
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-q SVD of the sparse (m, n) COO matrix with rows ``src`` and
    columns ``dst``."""
    src, dst = src.long(), dst.long()
    w = weight[:, None].to(torch.float32)

    def matvec(x):      # A·x: (n, r) → (m, r)
        return x.new_zeros((m, x.shape[1])).index_add_(0, src, x[dst] * w)

    def rmatvec(y):     # Aᵀ·y: (m, r) → (n, r)
        return y.new_zeros((n, y.shape[1])).index_add_(0, dst, y[src] * w)

    return randomized_svd(gen, matvec, rmatvec, m, n, q,
                          device=src.device, **kw)
