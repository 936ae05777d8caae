"""Plain LightGCN (He et al., SIGIR 2020, arXiv:2002.02126): the
benchmark's weights, the BPR + EmbLoss objective of a batch, the
validation's full-sort ranking and the served scores, in plain PyTorch.

Propagation is e^(l+1) = Â e^(l) over the symmetric-normalised
user–item graph of the training split (no self loops), the final
embedding the mean of e^0 … e^K; a batch's loss is
mean(-log(1e-10 + σ(s⁺ - s⁻))) + reg_weight · Σ‖e⁰‖² / 2 / B over
the batch's layer-0 rows (RecBole's BPRLoss and EmbLoss with
``require_pow``).  Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.common import (Precision, metric_bounds,
                                        rank_bounds, topk_metrics)
from portbench.reference.data import GeneralLog

NEG_INF = float("-inf")


def load_log(path: str, cfg: dict, seed: int) -> GeneralLog:
    return GeneralLog(path, seed)


def param_shapes(counts, cfg: dict) -> dict:
    """The weights' sizes from an object with ``n_users``/``n_items``
    (the program's model, or the reference's log)."""
    return {"n_users": int(counts.n_users), "n_items": int(counts.n_items),
            "d": int(cfg["embedding_size"])}


def shapes(log: GeneralLog, cfg: dict) -> dict:
    src, _, _, n = log.norm_adj()
    return {"n_users": log.n_users, "n_items": log.n_items, "n_nodes": n,
            "n_edges": len(src), "d": int(cfg["embedding_size"]),
            "n_layers": int(cfg["n_layers"]),
            "batch": int(cfg["train_batch_size"])}


def make_params(shp: dict, gen: torch.Generator, device) -> dict:
    """Xavier-uniform tables (RecBole's LightGCN initialisation) from
    one draw on ``device``."""
    d = shp["d"]
    rows = {"user_emb": shp["n_users"], "item_emb": shp["n_items"]}
    flat = torch.rand(sum(rows.values()) * d, generator=gen, device=device)
    out, at = {}, 0
    for name, n in rows.items():
        lim = math.sqrt(6.0 / (n + d))
        out[name] = ((flat[at:at + n * d] * 2 - 1) * lim).view(n, d)
        at += n * d
    return out


def flops_per_step(shp: dict) -> float:
    """K SpMMs forward and K back (2·E·d each) and the batch's two dot
    products (forward and the two gradients of each)."""
    d, k = shp["d"], shp["n_layers"]
    return 2 * k * 2 * shp["n_edges"] * d + 3 * 2 * 2 * shp["batch"] * d


def spmm_calls(shp: dict) -> tuple[int, int, int]:
    """(n_out, n_in, real edges) of each propagation SpMM."""
    return shp["n_nodes"], shp["n_nodes"], shp["n_edges"]


class Reference:

    def __init__(self, log: GeneralLog, cfg: dict, device,
                 precision: str = "f64"):
        self.log, self.device = log, device
        self.p = Precision(precision)
        self.n_layers = int(cfg["n_layers"])
        self.reg_weight = float(cfg["reg_weight"])
        src, dst, w, self.n = log.norm_adj()
        self.src = torch.from_numpy(src).to(device)
        self.dst = torch.from_numpy(dst).to(device)
        self.w = self.p.cast(torch.from_numpy(w).to(device))
        self.train_keys = np.sort(log.users[log.split == 0] * log.n_items
                                  + log.items[log.split == 0])

    def _spmm(self, h: torch.Tensor) -> torch.Tensor:
        msg = self.p.op(self.w)[:, None] * self.p.op(h)[self.src]
        return torch.zeros_like(h).index_add_(0, self.dst, msg)

    def final(self, params: dict) -> tuple[torch.Tensor, torch.Tensor]:
        h = torch.cat([self.p.cast(params["user_emb"].to(self.device)),
                       self.p.cast(params["item_emb"].to(self.device))])
        acc = h
        for _ in range(self.n_layers):
            h = self._spmm(h)
            acc = acc + h
        out = acc / (self.n_layers + 1)
        return out[:self.log.n_users], out[self.log.n_users:]

    # -- training ------------------------------------------------------

    def batch_faults(self, batch: dict) -> int:
        """Rows of a training batch that are not a training pair with a
        negative outside the user's training items."""
        u, i, j = (batch[k].astype(np.int64)
                   for k in ("user_id", "item_id", "neg_item_id"))
        keys = self.train_keys
        pos = np.isin(u * self.log.n_items + i, keys)
        neg = ~np.isin(u * self.log.n_items + j, keys) & (j >= 1) & \
            (j < self.log.n_items)
        return int((~(pos & neg)).sum())

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        dev = self.device
        user, pos, neg = (torch.from_numpy(batch[k]).long().to(dev)
                          for k in ("user_id", "item_id", "neg_item_id"))
        w = self.p.cast(torch.from_numpy(batch["weight"]).to(dev))
        ua, ia = self.final(params)
        u, pe, ne = self.p.op(ua[user]), self.p.op(ia[pos]), self.p.op(ia[neg])
        margin = (u * pe).sum(-1) - (u * ne).sum(-1)
        nb = torch.clamp(w.sum(), min=1.0)
        bpr = (-torch.log(1e-10 + torch.sigmoid(margin)) * w).sum() / nb
        e0 = [self.p.cast(params["user_emb"])[user],
              self.p.cast(params["item_emb"])[pos],
              self.p.cast(params["item_emb"])[neg]]
        reg = sum(((e * w[:, None]) ** 2).sum() for e in e0) / 2 / nb
        return bpr + self.reg_weight * reg

    # -- ranking -------------------------------------------------------

    def _history(self, parts) -> tuple[torch.Tensor, torch.Tensor]:
        """(user, item) pairs of the given splits, on the device."""
        m = np.isin(self.log.split, parts)
        return (torch.from_numpy(self.log.users[m]).to(self.device),
                torch.from_numpy(self.log.items[m]).to(self.device))

    def _scores(self, ua, ia, users: torch.Tensor) -> torch.Tensor:
        return self.p.mm(ua[users], ia.T)

    def validation(self, params: dict, k: int, chunk: int = 4096,
                   shift: bool = False, tol: float | None = None):
        """(metrics, users, bounds) of the validation: every user with
        validation items, scored over the catalogue, training items and
        PAD masked.  ``metrics`` are the reference's own top-k's (with
        ``shift``, a fault planted for calibration, each answer is the
        items ranked k+1 … 2k); with ``tol``, ``bounds`` gives each
        metric's (low, high) mean over every ranking within those ties
        (:func:`~portbench.reference.common.rank_bounds`)."""
        ua, ia = self.final(params)
        vu, vi = self._history([1])
        hu, hi = self._history([0])
        users = torch.unique(vu)
        row = torch.full((self.log.n_users,), -1, dtype=torch.long,
                         device=self.device)
        row[users] = torch.arange(len(users), device=self.device)
        order = torch.argsort(row[vu], stable=True)
        r, it = row[vu][order], vi[order]
        cnt = torch.bincount(r, minlength=len(users))
        start = torch.cumsum(cnt, 0) - cnt
        col = torch.arange(len(r), device=self.device) - start[r]
        pos = torch.full((len(users), int(cnt.max())), -1, dtype=torch.long,
                         device=self.device)
        pos[r, col] = it
        topk, sums = [], {}
        for lo in range(0, len(users), chunk):
            s = self._scores(ua, ia, users[lo:lo + chunk])
            sel = (row[hu] >= lo) & (row[hu] < lo + chunk)
            s[row[hu[sel]] - lo, hi[sel]] = NEG_INF
            s[:, 0] = NEG_INF
            topk.append(torch.topk(s, 2 * k, dim=1).indices[:, k:] if shift
                        else torch.topk(s, k, dim=1).indices)
            if tol is not None:
                b = metric_bounds(*rank_bounds(s, pos[lo:lo + chunk],
                                               cnt[lo:lo + chunk], tol),
                                  cnt[lo:lo + chunk], k)
                for name, v in b.items():
                    sums[name] = sums.get(name, 0.0) + v.sum(1)
        bounds = {name: (float(v[0]) / len(users), float(v[1]) / len(users))
                  for name, v in sums.items()}
        return topk_metrics(torch.cat(topk), pos, cnt, k), len(users), bounds

    def served_scores(self, params: dict, user_tokens) -> torch.Tensor:
        """(R, n_items) scores of each requested user over the catalogue,
        every logged item of the user and PAD at -inf (the server masks
        all three splits)."""
        ua, ia = self.final(params)
        tok2id = {int(t): i for i, t in enumerate(self.log.user_vocab)
                  if i}
        users = torch.tensor([tok2id[int(t)] for t in user_tokens],
                             device=self.device)
        s = self._scores(ua, ia, users)
        hu, hi = self._history([0, 1, 2])
        for r, uid in enumerate(users.tolist()):
            s[r, hi[hu == uid]] = NEG_INF
        s[:, 0] = NEG_INF
        return s

    def item_ids(self, tokens) -> np.ndarray:
        """Reference item ids of served item tokens (-1: unknown)."""
        tok2id = {str(t): i for i, t in enumerate(self.log.item_vocab)
                  if i}
        return np.array([tok2id.get(str(t), -1) for t in tokens], np.int64)
