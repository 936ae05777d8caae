"""Precision modes, Adam and the ranking metrics of the plain
references.

A reference computes in one of two modes.  ``"f64"`` is the yardstick:
every product and sum in float64.  ``"tf32"`` is the control: the
operands of every product rounded to TF32 (10 explicit mantissa bits,
to nearest) and summed in float32, as a tensor-core matmul with TF32
on would, which is the step below the float32 (TF32 off) that the
configurations state.  The rounding is explicit, so the control reads
the same on the CPU and on the card.
"""

from __future__ import annotations

import torch


def set_exact_matmul() -> None:
    """float32 matmuls in float32 (TF32 off), on every device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest (ties away) at 10 mantissa
    bits; non-finite values pass."""
    x = x.float().contiguous()
    bits = x.view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


class Precision:
    """``cast`` gives a tensor in the mode's working type; ``op`` gives
    the operand of a product (rounded to TF32 in the control)."""

    def __init__(self, mode: str):
        if mode not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self.dtype = torch.float64 if mode == "f64" else torch.float32

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    def op(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.mode == "tf32":
            # autograd passes through the rounding (straight through)
            x = x + (round_tf32(x) - x).detach()
        return x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.op(a) @ self.op(b)


def adam_steps(params: dict, grad_fn, n_steps: int, lr: float = 1e-3,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """``n_steps`` of Adam (coupled, no weight decay) from ``params``
    (float64 leaves) → (losses, the first step's gradients, params after
    the steps).  ``grad_fn(params, step)`` → (loss, grads)."""
    p = {k: v.clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for t in range(1, n_steps + 1):
        loss, g = grad_fn(p, t - 1)
        losses.append(float(loss))
        if first is None:
            first = {k: x.clone() for k, x in g.items()}
        for k in p:
            m[k] = b1 * m[k] + (1 - b1) * g[k]
            v2[k] = b2 * v2[k] + (1 - b2) * g[k] * g[k]
            mh = m[k] / (1 - b1 ** t)
            vh = v2[k] / (1 - b2 ** t)
            p[k] = p[k] - lr * mh / (torch.sqrt(vh) + eps)
    return losses, first, p


def topk_metrics(topk: torch.Tensor, pos: torch.Tensor,
                 pos_len: torch.Tensor, k: int) -> dict[str, float]:
    """Mean Recall, MRR, NDCG, Hit and Precision @k of (U, k) ranked
    ids against each row's positives: the first ``pos_len`` ids of its
    row of ``pos`` (U, P)."""
    dev = topk.device
    cols = torch.arange(pos.shape[1], device=dev)
    real = torch.where(cols[None, :] < pos_len[:, None], pos,
                       torch.full_like(pos, -1))
    rel = (topk[:, :k, None] == real[:, None, :]).any(-1).double()
    hits = rel.sum(1)
    n = pos_len.double()
    disc = 1.0 / torch.log2(torch.arange(2, k + 2, dtype=torch.float64,
                                         device=dev))
    ideal = torch.cumsum(disc, 0)[torch.clamp(pos_len, max=k) - 1]
    first = torch.argmax(rel, dim=1).double()
    out = {"recall": hits / n, "precision": hits / k,
           "hit": (hits > 0).double(),
           "mrr": torch.where(hits > 0, 1.0 / (first + 1.0),
                              torch.zeros_like(hits)),
           "ndcg": (rel * disc).sum(1) / ideal}
    return {f"{name}@{k}": float(v.mean()) for name, v in out.items()}


def rank_bounds(scores: torch.Tensor, pos: torch.Tensor, pos_len: torch.Tensor,
                tol: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(best, worst) rank (1-based) that each positive of each row can
    take in a ranking of the row's scores where scores within ``tol``
    times the row's largest finite magnitude count as tied: 1 plus the
    items scored above it by more than that, and the items scored no
    further below it than that.  Padding slots read a rank past the
    catalogue."""
    fin = torch.isfinite(scores)
    scale = torch.where(fin, scores.abs(), torch.zeros_like(scores)).amax(1)
    delta = (tol * scale)[:, None]
    asc = torch.sort(-scores, dim=1).values          # best first, negated
    cols = torch.arange(pos.shape[1], device=pos.device)
    real = cols[None, :] < pos_len[:, None]
    s = torch.gather(scores, 1, torch.where(real, pos, torch.zeros_like(pos)))
    best = torch.searchsorted(asc, (-(s + delta)).contiguous(),
                              right=False) + 1
    worst = torch.searchsorted(asc, (-(s - delta)).contiguous(), right=True)
    far = scores.shape[1] + 1
    return (torch.where(real, best, torch.full_like(best, far)),
            torch.where(real, worst, torch.full_like(worst, far)))


def metric_bounds(best: torch.Tensor, worst: torch.Tensor,
                  pos_len: torch.Tensor, k: int) -> dict[str, torch.Tensor]:
    """Per row, the lowest and highest Recall, MRR, NDCG, Hit and
    Precision @k that any ranking within the ties of
    :func:`rank_bounds` gives: (2, U) each, the low row first.  A
    positive counts at its best rank for the high end and at its worst
    for the low end (two positives tied for one place both count at the
    high end, so the interval holds every such ranking)."""
    disc = 1.0 / torch.log2(torch.arange(2, k + 2, dtype=torch.float64,
                                         device=best.device))
    n = pos_len.double()
    ideal = torch.cumsum(disc, 0)[torch.clamp(pos_len, max=k) - 1]
    out = {}
    for end, r in (("lo", worst), ("hi", best)):
        inside = r <= k
        hits = inside.sum(1).double().clamp(max=k)
        first = torch.where(inside, r, torch.full_like(r, k + 1)).amin(1)
        gain = torch.where(inside, disc[(r - 1).clamp(0, k - 1)],
                           torch.zeros_like(disc[:1]))
        out[end] = {"recall": hits / n, "precision": hits / k,
                    "hit": (hits > 0).double(),
                    "mrr": torch.where(first <= k, 1.0 / first.double(),
                                       torch.zeros_like(n)),
                    "ndcg": (gain.sum(1) / ideal).clamp(max=1.0)}
    return {f"{m}@{k}": torch.stack([out["lo"][m], out["hi"][m]])
            for m in out["lo"]}
