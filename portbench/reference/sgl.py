"""Plain SGL-ED (Wu et al., SIGIR 2021, arXiv:2010.10783, as
RecBole-GNN's ``SGL`` trains it): the benchmark's weights, the loss of a
batch over the graph and two edge-dropped views, and the validation's
full-sort ranking, in plain PyTorch.

Each view keeps every training interaction with probability 1 − ρ
(``drop_ratio``) and is re-normalised as D^-½ A D^-½ over the pairs it
kept, both directions, no self loops.  A step propagates the embeddings
K = ``n_layers`` times over the graph and over each view, each output
the mean of layers 0 … K, and its loss is

    Σ_b −log σ(s⁺ − s⁻) over the graph's output (summed BPR)
    + reg_weight · Σ over the batch's layer-0 user, positive and
      negative blocks of ‖block‖₂, over B (EmbLoss without
      ``require_pow``)
    + ssl_weight · Σ_b [logsumexp_n(ẑ¹_b · ẑ²_n / τ) − ẑ¹_b · ẑ²_b / τ]
      for the batch's users against every user row of view 2, and for
      its positive items against every item row (InfoNCE, τ = ``ssl_tau``;
      ẑ a row L2-normalised).

Departures from RecBole-GNN's ``SGL``, each the program's too:

* the views: RecBole-GNN keeps a random subset of exactly
  ⌊(1 − ρ)·n⌋ interactions; here each interaction is kept on its own
  draw, ``rand ≥ ρ``, the program's protocol (:func:`keep_masks`), so
  that the reference draws the program's two set-up views itself;
* batch rows weigh ``weight``: the loaders pad the last batch of an
  epoch with weight-0 rows, which add nothing to any term, and B is
  max(Σ weight, 1);
* the InfoNCE is written as logsumexp − positive where RecBole-GNN
  writes −log(exp(positive) / Σ exp), the same number.

The validation is LightGCN's over the graph (``reference/lightgcn.py``):
SGL ranks with its graph's propagation.  Nothing here imports the
program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import lightgcn
from portbench.reference.data import GeneralLog

param_shapes = lightgcn.param_shapes
shapes = lightgcn.shapes
make_params = lightgcn.make_params
spmm_calls = lightgcn.spmm_calls     # the views' layouts hold every edge


class ViewLog(GeneralLog):
    """The log with the run's seed and its training interactions in the
    program's order (:attr:`train_rows`): RecBole's grouped ratio split
    takes the users in the order they first appear in the shuffled log
    and each user's rows in shuffled order."""

    def __init__(self, path: str, seed: int):
        super().__init__(path, seed)
        self.seed = seed
        n = len(self.users)
        perm = np.random.default_rng(seed).permutation(n)
        at = np.empty(n, np.int64)
        at[perm] = np.arange(n)                   # each row's shuffled place
        first = np.full(self.n_users, n, np.int64)
        np.minimum.at(first, self.users, at)      # each user's first place
        rows = np.flatnonzero(self.split == 0)
        self.train_rows = rows[np.lexsort((at[rows],
                                           first[self.users[rows]]))]


def load_log(path: str, cfg: dict, seed: int) -> ViewLog:
    return ViewLog(path, seed)


def _seeds(gen: torch.Generator, n: int) -> list[int]:
    return torch.randint(0, 2 ** 62, (n,), generator=gen,
                         device=gen.device).tolist()


def keep_masks(seed: int, n_inter: int, drop_ratio: float,
               device) -> list[torch.Tensor]:
    """The two keep masks of the set-up's views over the training
    interactions, drawn as the program draws them from the run's seed:
    a host generator seeded with it; on a card, a generator there seeded
    by one draw from it; two seeds from that, one generator each; one
    seed from each of those (one repetition of ED), one generator each;
    ``rand(n_inter) ≥ drop_ratio`` from those."""
    gen = torch.Generator().manual_seed(seed)
    dev = torch.device(device)
    if dev.type != "cpu":
        gen = torch.Generator(device=dev).manual_seed(_seeds(gen, 1)[0])
    out = []
    for s in _seeds(gen, 2):
        g = torch.Generator(device=gen.device).manual_seed(s)
        g = torch.Generator(device=gen.device).manual_seed(_seeds(g, 1)[0])
        out.append(torch.rand(n_inter, generator=g,
                              device=gen.device) >= drop_ratio)
    return out


def flops_per_step(shp: dict) -> float:
    """Three propagations of K SpMMs forward and K back (2·E·d each),
    the InfoNCE's logits over every node (2·B·n·d forward, twice that
    back), and the batch's four dot products (BPR's two, the InfoNCE's
    two positives: forward and the two gradients of each)."""
    d, k, b = shp["d"], shp["n_layers"], shp["batch"]
    n = shp["n_users"] + shp["n_items"]
    return (3 * 2 * k * 2 * shp["n_edges"] * d + 3 * 2 * b * n * d
            + 4 * 3 * 2 * b * d)


class Reference(lightgcn.Reference):

    def __init__(self, log: ViewLog, cfg: dict, device,
                 precision: str = "f64"):
        super().__init__(log, cfg, device, precision)
        if str(cfg.get("type", "ED")) != "ED":
            raise ValueError("the reference draws ED views only")
        self.tau = float(cfg["ssl_tau"])
        self.ssl_weight = float(cfg["ssl_weight"])
        u = log.users[log.train_rows]
        i = log.items[log.train_rows]
        self.keeps = keep_masks(log.seed, len(u), float(cfg["drop_ratio"]),
                                device)
        self.views = [self._view_graph(u, i, k.cpu().numpy())
                      for k in self.keeps]

    def _view_graph(self, u, i, keep):
        """(src, dst, weight) of a view: its kept pairs both ways, each
        weighted 1/sqrt(deg(src)·deg(dst)) over the kept edges."""
        u, i = u[keep], i[keep] + self.log.n_users
        src, dst = np.concatenate([u, i]), np.concatenate([i, u])
        deg = np.bincount(dst, minlength=self.n).astype(np.float64)
        inv = np.zeros(self.n)
        inv[deg > 0] = deg[deg > 0] ** -0.5
        t = lambda a: torch.from_numpy(a).to(self.device)
        return t(src), t(dst), self.p.cast(t(inv[src] * inv[dst]))

    def _mean_layers(self, params, graph):
        src, dst, w = graph
        h = torch.cat([self.p.cast(params["user_emb"].to(self.device)),
                       self.p.cast(params["item_emb"].to(self.device))])
        acc = h
        for _ in range(self.n_layers):
            msg = self.p.op(w)[:, None] * self.p.op(h)[src]
            h = torch.zeros_like(h).index_add_(0, dst, msg)
            acc = acc + h
        out = acc / (self.n_layers + 1)
        return out[:self.log.n_users], out[self.log.n_users:]

    def _info_nce(self, z1, z2, all2, w):
        z1, z2, all2 = (F.normalize(z, dim=1) for z in (z1, z2, all2))
        pos = (self.p.op(z1) * self.p.op(z2)).sum(-1) / self.tau
        lse = torch.logsumexp(self.p.mm(z1, all2.T) / self.tau, dim=-1)
        return ((lse - pos) * w).sum()

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        dev = self.device
        user, pos, neg = (torch.from_numpy(batch[k]).long().to(dev)
                          for k in ("user_id", "item_id", "neg_item_id"))
        w = self.p.cast(torch.from_numpy(batch["weight"]).to(dev))
        ua, ia = self.final(params)
        u1, i1 = self._mean_layers(params, self.views[0])
        u2, i2 = self._mean_layers(params, self.views[1])
        u, pe, ne = self.p.op(ua[user]), self.p.op(ia[pos]), self.p.op(ia[neg])
        margin = (u * pe).sum(-1) - (u * ne).sum(-1)
        bpr = (-F.logsigmoid(margin) * w).sum()
        e0 = [self.p.cast(params["user_emb"])[user],
              self.p.cast(params["item_emb"])[pos],
              self.p.cast(params["item_emb"])[neg]]
        nb = torch.clamp(w.sum(), min=1.0)
        reg = sum(torch.sqrt(((e * w[:, None]) ** 2).sum()) for e in e0) / nb
        ssl = (self._info_nce(u1[user], u2[user], u2, w)
               + self._info_nce(i1[pos], i2[pos], i2, w))
        return bpr + self.reg_weight * reg + self.ssl_weight * ssl
