"""Plain SR-GNN (Wu et al., AAAI 2019, arXiv:1811.00855, as RecBole-GNN
implements it): the benchmark's weights, the cross-entropy of a batch
over the whole catalogue, the validation's full-sort ranking and the
served scores, in plain PyTorch.

A session's graph has one node per distinct item, an edge u → v for
each pair of consecutive clicks (each edge once, self loops kept), and
row-normalised in- and out-adjacencies A_in, A_out.  One step of the
gated cell:

    a_in = A_in (h W_in + b_in),  a_out = A_out (h W_out + b_out),
    [r_i, z_i, n_i] = [a_in; a_out] W_ih + b_ih,
    [r_h, z_h, n_h] = h W_hh + b_hh,
    r = σ(r_i + r_h),  z = σ(z_i + z_h),  n = tanh(n_i + r·n_h),
    h' = (1 - z)·h + z·n.

The readout, with h_t the last click's state:

    α_p = w₃·σ(W₁h_t + b₁ + W₂h_p + b₂),  s = Σ_p α_p h_p,
    out = W₄[s; h_t] + b₄,  scores = out · Eᵀ

over every item row, PAD's row 0 included in training.  The nodes here
are indexed by the first position at which their item occurs, not by
the sorted item ids as in the program: the result does not depend on
the order of the nodes.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.common import (Precision, metric_bounds,
                                        rank_bounds, topk_metrics)
from portbench.reference.data import SessionLog

NEG_INF = float("-inf")


def load_log(path: str, cfg: dict, seed: int) -> SessionLog:
    k = int(str(cfg["user_inter_num_interval"]).strip("[").split(",")[0])
    return SessionLog(path, int(cfg["MAX_ITEM_LIST_LENGTH"]), k)


def param_shapes(counts, cfg: dict) -> dict:
    """The weights' sizes from an object with ``n_items`` (the
    program's model, or the reference's log)."""
    return {"n_items": int(counts.n_items), "d": int(cfg["embedding_size"])}


def shapes(log: SessionLog, cfg: dict) -> dict:
    return {"n_items": log.n_items, "d": int(cfg["embedding_size"]),
            "L": int(cfg["MAX_ITEM_LIST_LENGTH"]), "step": int(cfg["step"]),
            "batch": int(cfg["train_batch_size"]),
            "n_train": int((log.part == 0).sum())}


def leaf_shapes(shp: dict) -> dict[str, tuple[int, ...]]:
    d = shp["d"]
    out = {"item_emb": (shp["n_items"], d)}
    for name, (i, o) in {"in_conv": (d, d), "out_conv": (d, d),
                         "lin_ih": (2 * d, 3 * d),
                         "lin_hh": (d, 3 * d)}.items():
        out[f"cell.{name}.w"] = (i, o)
        out[f"cell.{name}.b"] = (o,)
    for name, (i, o) in {"linear_one": (d, d), "linear_two": (d, d),
                         "linear_three": (d, 1),
                         "linear_transform": (2 * d, d)}.items():
        out[f"readout.{name}.w"] = (i, o)
        if name != "linear_three":
            out[f"readout.{name}.b"] = (o,)
    return out


def make_params(shp: dict, gen: torch.Generator, device) -> dict:
    """Every leaf uniform on ±1/sqrt(d) (RecBole's SR-GNN
    initialisation) from one draw on ``device``."""
    sizes = leaf_shapes(shp)
    flat = torch.rand(sum(math.prod(s) for s in sizes.values()),
                      generator=gen, device=device)
    stdv = 1.0 / math.sqrt(shp["d"])
    out, at = {}, 0
    for name, s in sizes.items():
        n = math.prod(s)
        out[name] = ((flat[at:at + n] * 2 - 1) * stdv).view(s)
        at += n
    return out


def flops_per_step(shp: dict) -> float:
    """Forward and backward (3 × forward) of a batch at the padded
    length L: the cell's linears and adjacency products, the readout
    and the (B, d) × (d, n_items) logits."""
    d, L, n = shp["d"], shp["L"], shp["n_items"]
    cell = (2 * L * d * d * 2 + 2 * L * L * d * 2 + L * 2 * d * 3 * d * 2
            + L * d * 3 * d * 2)
    readout = L * d * d * 2 + d * d * 2 + L * d * 2 + 2 * d * d * 2
    return 3.0 * shp["batch"] * (shp["step"] * cell + readout + d * n * 2)


class Reference:

    def __init__(self, log: SessionLog, cfg: dict, device,
                 precision: str = "f64"):
        self.log, self.device = log, device
        self.p = Precision(precision)
        self.step = int(cfg["step"])
        self.L = int(cfg["MAX_ITEM_LIST_LENGTH"])
        seqs, lens, tgt = log.samples(0)
        sess = log.sess_of_sample[log.part == 0]
        self._train = {}
        for key in zip(sess.tolist(), map(bytes, seqs.astype(np.int64)),
                       lens.tolist(), tgt.tolist()):
            self._train[key] = self._train.get(key, 0) + 1

    # -- the model -----------------------------------------------------

    def _lin(self, params, name, x):
        y = self.p.op(x) @ self.p.op(params[f"{name}.w"])
        b = params.get(f"{name}.b")
        return y if b is None else y + self.p.cast(b)

    def session_out(self, params: dict, seqs: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
        """(B, d) session representations of (B, L) item ids."""
        B, L = seqs.shape
        pos = torch.arange(L, device=seqs.device)
        valid = pos[None, :] < lens[:, None]
        same = (seqs[:, :, None] == seqs[:, None, :]) & valid[:, None, :]
        node = torch.argmax(same.int(), dim=2)          # first occurrence
        node = torch.where(valid, node, torch.zeros_like(node))
        first = valid & (node == pos[None, :])
        emb = self.p.cast(params["item_emb"])
        h = torch.where(first[:, :, None], emb[seqs], 0.0)
        a = torch.zeros(B, L, L, dtype=h.dtype, device=h.device)
        e_ok = pos[None, :-1] < (lens[:, None] - 1)
        b_idx = torch.arange(B, device=h.device)[:, None].expand(B, L - 1)
        a[b_idx[e_ok], node[:, 1:][e_ok], node[:, :-1][e_ok]] = 1.0
        a_in = a / a.sum(-1, keepdim=True).clamp_min(1.0)
        at = a.transpose(1, 2)
        a_out = at / at.sum(-1, keepdim=True).clamp_min(1.0)
        for _ in range(self.step):
            x_in = self.p.op(a_in) @ self.p.op(self._lin(params,
                                                         "cell.in_conv", h))
            x_out = self.p.op(a_out) @ self.p.op(
                self._lin(params, "cell.out_conv", h))
            gi = self._lin(params, "cell.lin_ih", torch.cat([x_in, x_out], -1))
            gh = self._lin(params, "cell.lin_hh", h)
            ir, iz, i_n = gi.chunk(3, -1)
            hr, hz, hn = gh.chunk(3, -1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            n = torch.tanh(i_n + r * hn)
            h = (1 - z) * h + z * n
        seq_h = torch.gather(h, 1, node[:, :, None].expand(B, L, h.shape[2]))
        ht = seq_h[torch.arange(B, device=h.device), (lens - 1).clamp_min(0)]
        q = torch.sigmoid(self._lin(params, "readout.linear_one", ht)[:, None]
                          + self._lin(params, "readout.linear_two", seq_h))
        alpha = self._lin(params, "readout.linear_three", q)
        s = (alpha * seq_h * valid[:, :, None]).sum(1)
        return self._lin(params, "readout.linear_transform",
                         torch.cat([s, ht], -1))

    def logits(self, params, seqs, lens) -> torch.Tensor:
        params = {k: v.to(self.device) for k, v in params.items()}
        return self.p.mm(self.session_out(params, seqs, lens),
                         params["item_emb"].T)

    # -- training ------------------------------------------------------

    def batch_faults(self, batch: dict) -> int:
        """Rows of a training batch that are not a training sample of
        the log (more often than the log holds it)."""
        seen: dict = {}
        bad = 0
        seqs = batch["item_seq"].astype(np.int64)
        for r in range(len(seqs)):
            if batch["weight"][r] == 0:
                continue
            key = (int(batch["user_id"][r]), bytes(seqs[r]),
                   int(batch["item_seq_len"][r]), int(batch["item_id"][r]))
            seen[key] = seen.get(key, 0) + 1
            bad += seen[key] > self._train.get(key, 0)
        return bad

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        dev = self.device
        seqs = torch.from_numpy(batch["item_seq"]).long().to(dev)
        lens = torch.from_numpy(batch["item_seq_len"]).long().to(dev)
        tgt = torch.from_numpy(batch["item_id"]).long().to(dev)
        w = self.p.cast(torch.from_numpy(batch["weight"]).to(dev))
        logp = torch.log_softmax(self.logits(params, seqs, lens), -1)
        nll = -logp.gather(1, tgt[:, None])[:, 0]
        return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)

    # -- ranking -------------------------------------------------------

    def validation(self, params: dict, k: int, chunk: int = 2048,
                   shift: bool = False, tol: float | None = None):
        """(metrics, sessions, bounds) of the validation: each session's
        validation sample scored over the catalogue, PAD masked, no
        history mask.  ``metrics`` are the reference's own top-k's (with
        ``shift``, a fault planted for calibration, each answer is the
        items ranked k+1 … 2k); with ``tol``, ``bounds`` gives each
        metric's (low, high) mean over every ranking within those ties
        (:func:`~portbench.reference.common.rank_bounds`)."""
        seqs, lens, tgt = self.log.samples(1)
        pos = torch.from_numpy(tgt).to(self.device)[:, None]
        one = torch.ones(len(tgt), dtype=torch.long, device=self.device)
        topk, sums = [], {}
        for lo in range(0, len(seqs), chunk):
            s = self.logits(
                params, torch.from_numpy(seqs[lo:lo + chunk]).to(self.device),
                torch.from_numpy(lens[lo:lo + chunk]).to(self.device))
            s[:, 0] = NEG_INF
            topk.append(torch.topk(s, 2 * k, dim=1).indices[:, k:] if shift
                        else torch.topk(s, k, dim=1).indices)
            if tol is not None:
                p, n = pos[lo:lo + chunk], one[lo:lo + chunk]
                b = metric_bounds(*rank_bounds(s, p, n, tol), n, k)
                for name, v in b.items():
                    sums[name] = sums.get(name, 0.0) + v.sum(1)
        bounds = {name: (float(v[0]) / len(tgt), float(v[1]) / len(tgt))
                  for name, v in sums.items()}
        return topk_metrics(torch.cat(topk), pos, one, k), len(tgt), bounds

    def served_scores(self, params: dict, sessions) -> torch.Tensor:
        """(R, n_items) scores of each requested session (item tokens,
        oldest first; its last L clicks), PAD at -inf."""
        tok2id = {int(t): i for i, t in enumerate(self.log.item_vocab) if i}
        seqs = np.zeros((len(sessions), self.L), np.int64)
        lens = np.zeros(len(sessions), np.int64)
        for r, s in enumerate(sessions):
            ids = [tok2id[int(t)] for t in s][-self.L:]
            seqs[r, :len(ids)] = ids
            lens[r] = len(ids)
        s = self.logits(params, torch.from_numpy(seqs).to(self.device),
                        torch.from_numpy(lens).to(self.device))
        s[:, 0] = NEG_INF
        return s

    def item_ids(self, tokens) -> np.ndarray:
        tok2id = {str(t): i for i, t in enumerate(self.log.item_vocab) if i}
        return np.array([tok2id.get(str(t), -1) for t in tokens], np.int64)
