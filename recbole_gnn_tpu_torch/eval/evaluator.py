"""Evaluator — full-sort and uniN/popN top-k evaluation.

Port of the general paths of ``recbole_gnn_tpu/eval/evaluator.py``.
Factorized models propagate the full graph ONCE per evaluation (under
``torch.no_grad()``), then score each batch of users against the whole
catalog (U·Iᵀ with ``torch.matmul``, which the JAX package leaves to
XLA), mask the train history and the PAD item to ``NEG_INF`` by
``scatter_`` on the 0-padded history matrix, and take ``torch.topk``.
uniN/popN rank within sampled candidate lists.  Non-factorized models
score through ``model.score_users_vs_all``.

Metric contributions are weighted sums (padded eval rows have weight 0)
kept on the device and read once at the end.  ``eval_scan`` (a TPU
dispatch-latency knob) runs the same per-batch loop with the same
results.  The sequential path and mesh-sharded scoring are not ported.
"""

from __future__ import annotations

import torch

from recbole_gnn_tpu_torch.eval.metrics import topk_metrics
from recbole_gnn_tpu_torch.ops.topk import NEG_INF, masked_topk
from recbole_gnn_tpu_torch.utils.enums import ModelType


def to_device(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """A numpy batch dict on ``device``: integer arrays as int64, the
    rest as float32."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        t = t.long() if not t.is_floating_point() else t.float()
        out[k] = t.to(device, non_blocking=True)
    return out


class Evaluator:

    def __init__(self, config, model, mesh=None):
        if model.model_type == ModelType.SEQUENTIAL:
            raise NotImplementedError(
                "sequential evaluation is not ported to recbole_gnn_tpu_torch "
                "yet (ROADMAP §1 Slice C item 6)")
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded evaluation is not ported to "
                "recbole_gnn_tpu_torch yet (ROADMAP §1 Slice E item 9)")
        self.config = config
        self.model = model
        self.device = model.device
        self.topk = tuple(config["topk"])
        self.max_k = max(self.topk)
        self.metrics = tuple(m.lower() for m in (
            config.get("metrics", ["Recall", "MRR", "NDCG", "Hit",
                                   "Precision"])))
        self.n_items = model.n_items

    # -- per-batch scoring --------------------------------------------

    def _metric_sums(self, topk_idx, batch):
        vals = topk_metrics(topk_idx, batch["pos_items"], batch["pos_len"],
                            self.topk)
        w = batch["weight"]
        sums = {k: (v * w).sum() for k, v in vals.items()}
        sums["__weight__"] = w.sum()
        return sums

    def _full_sort_sums(self, scores, batch):
        """Mask history + PAD on a (B, n_items) score matrix, top-k."""
        scores.scatter_(1, batch["history_items"], NEG_INF)
        scores[:, 0] = NEG_INF   # PAD item (also where history is padded)
        _, idx = masked_topk(scores, self.max_k)
        return self._metric_sums(idx, batch)

    def _candidate_sums(self, cscores, batch):
        """Rank within each row's candidate list (``cand_len`` valid)."""
        cand = batch["candidates"]
        cols = torch.arange(cand.shape[1], device=cand.device)
        valid = cols[None, :] < batch["cand_len"][:, None]
        cscores = cscores.masked_fill(~valid, NEG_INF)
        k = min(self.max_k, cand.shape[1])
        _, pos_idx = torch.topk(cscores, k, dim=1)
        topk_items = torch.gather(cand, 1, pos_idx)
        if k < self.max_k:   # pad with the PAD item (never relevant)
            topk_items = torch.nn.functional.pad(
                topk_items, (0, self.max_k - k))
        return self._metric_sums(topk_items, batch)

    # -- public API -----------------------------------------------------

    def evaluate(self, params, extras, loader, mode: str = "full") -> dict:
        """Run a full evaluation pass; returns {metric@k: float}."""
        totals: dict[str, torch.Tensor] = {}
        with torch.no_grad():
            if self.model.factorized_eval:
                user_all, item_all = self.model.propagate(
                    params, self.model.consts, extras)
            for batch in loader:
                b = to_device(batch, self.device)
                users = b["user_id"]
                if self.model.factorized_eval:
                    u_e = user_all[users]
                    if mode == "full":
                        sums = self._full_sort_sums(
                            torch.matmul(u_e, item_all.T), b)
                    else:
                        c_e = item_all[b["candidates"]]
                        sums = self._candidate_sums(
                            torch.einsum("bd,bcd->bc", u_e, c_e), b)
                else:
                    scores = self.model.score_users_vs_all(params, users)
                    if mode == "full":
                        sums = self._full_sort_sums(scores, b)
                    else:
                        sums = self._candidate_sums(
                            torch.gather(scores, 1, b["candidates"]), b)
                for k, v in sums.items():
                    totals[k] = v if k not in totals else totals[k] + v
        if not totals:
            return {}
        # one device→host read for the whole pass
        host = dict(zip(totals, torch.stack(list(totals.values())).cpu()
                        .tolist()))
        w = max(host.pop("__weight__"), 1e-12)
        out = {}
        for name in self.metrics:
            for k in self.topk:
                key = f"{name}@{k}"
                if key in host:
                    out[key] = host[key] / w
        return out
