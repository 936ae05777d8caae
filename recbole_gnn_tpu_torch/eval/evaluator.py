"""Evaluator — full-sort and uniN/popN top-k evaluation.

Port of ``recbole_gnn_tpu/eval/evaluator.py``.  Factorized models
propagate the full graph ONCE per evaluation (under
``torch.no_grad()``), then score each batch of users against the whole
catalog (U·Iᵀ with ``torch.matmul``, which the JAX package leaves to
XLA), mask the train history and the PAD item to ``NEG_INF`` by
``scatter_`` on the 0-padded history matrix, and take ``torch.topk``.
uniN/popN rank within sampled candidate lists.  Non-factorized models
score through ``model.score_users_vs_all``.  Sequential models score
each session batch with ``model.full_scores(..., train=False)``: full
sort sets the PAD column to ``NEG_INF`` and masks no history (the
[recbole] sequential convention), uniN/popN rank the target among its
sampled candidates.

Metric contributions are weighted sums kept on the device and read
once at the end.  A general model's full-sort batch is scored without
its weight-0 padding rows and in user chunks of at most
``SCORE_BYTES_BUDGET`` bytes of scores, so ``eval_batch_size`` (users
per batch, as in the JAX package) bounds no device allocation.
``eval_scan`` (a TPU dispatch-latency knob) runs the same per-batch
loop with the same results.

A general model's full sort over a ``FullSortEvalLoader`` (mode
``full``, no item-sharded mesh) reads the loader's arrays from the
device: its first pass on a device places the fixed arrays there once
(the eval users, the padded positives and their counts, the history
as CSR: row pointer, entry rows and items, not the padded history
matrix) and caches them on the loader (``FullSortEvalLoader.resident``),
and every pass slices each chunk from them, on the chunk boundaries
above, and masks the chunk's history by one ``index_put_`` at (row,
item) plus the PAD column.  The masked entries, scores, top-k and sums
are those of the host batches, so the metrics are the same bit for
bit.  uniN/popN, the sequential models and the item-sharded path
iterate the loader on the host and copy each batch.

Counters (``utils/trace.py``, in the span ``evaluate``; ``fit/evaluate``
inside ``fit``): ``passes`` (one an evaluation), ``chunks`` (every
chunk or batch scored), ``resident_chunks`` (those sliced from arrays
resident on the device) and ``h2d_bytes`` (the bytes of the host
arrays the evaluator handed to the model's device, the one-time
placement included; counted on a CPU device too, where the hand-over
copies nothing).

With a mesh (``Evaluator(mesh=)``, the trainer's) whose ``tp`` axis has
more than one rank, a factorized model's full sort runs item-sharded
(``parallel/topk.distributed_full_sort_topk``): every rank of the
``tp`` line scores the batch against its block of the catalog (padded
with PAD rows to the shard multiple), and the (B, k) candidates are
merged; every rank gets the same metrics.
"""

from __future__ import annotations

import numpy as np
import torch

from recbole_gnn_tpu_torch.data.loader import FullSortEvalLoader
from recbole_gnn_tpu_torch.eval.metrics import topk_metrics
from recbole_gnn_tpu_torch.ops.topk import NEG_INF, masked_topk
from recbole_gnn_tpu_torch.parallel.mesh import axis_group, axis_size
from recbole_gnn_tpu_torch.parallel.topk import (distributed_full_sort_topk,
                                                 item_shard)
from recbole_gnn_tpu_torch.utils import trace
from recbole_gnn_tpu_torch.utils.enums import ModelType

# bytes of (users, n_items) f32 scores one full-sort chunk may make
SCORE_BYTES_BUDGET = 1 << 30


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
        self.config = config
        self.model = model
        self.device = model.device
        self.topk = tuple(config["topk"])
        self.max_k = max(self.topk)
        self.metrics = tuple(m.lower() for m in config.or_default(
            "metrics", ["Recall", "MRR", "NDCG", "Hit", "Precision"]))
        self.n_items = model.n_items
        self.is_sequential = model.model_type == ModelType.SEQUENTIAL
        self.mesh = mesh
        # the last evaluate()'s span, in seconds
        self.last_seconds = None

    # -- per-batch scoring --------------------------------------------

    def _metric_sums(self, topk_idx, batch):
        vals = topk_metrics(topk_idx, batch["pos_items"], batch["pos_len"],
                            self.topk)
        w = batch["weight"]
        sums = {k: (v * w).sum() for k, v in vals.items()}
        sums["__weight__"] = w.sum()
        return sums

    def _sequential_sums(self, params, extras, batch, mode):
        scores = self.model.full_scores(params, self.model.consts, extras,
                                        batch, None, False)
        if mode == "full":
            scores[:, 0] = NEG_INF   # PAD item; no history mask
            _, idx = masked_topk(scores, self.max_k)
            return self._metric_sums(idx, batch)
        return self._candidate_sums(
            torch.gather(scores, 1, batch["candidates"]), batch)

    def _use_dist_eval(self, mode: str) -> bool:
        return (mode == "full" and self.mesh is not None
                and axis_size(self.mesh, "tp") > 1)

    def _dist_full_sort_sums(self, u_e, item_block, batch):
        """Item-sharded full sort of one batch: this rank's block of the
        catalog, the history with a 0 column appended (the PAD item is
        always excluded), the merged top-k."""
        hist = torch.nn.functional.pad(batch["history_items"], (0, 1))
        _, idx = distributed_full_sort_topk(
            u_e, item_block, hist, self.max_k, axis_group(self.mesh, "tp"),
            n_valid_items=self.n_items)
        return self._metric_sums(idx, batch)

    def _full_sort_sums(self, scores, batch):
        """Mask history + PAD on a (B, n_items) score matrix, top-k.  A
        host batch carries the padded ``history_items``, a resident
        chunk the (``hist_row``, ``hist_item``) pairs of its history."""
        if "history_items" in batch:
            scores.scatter_(1, batch["history_items"], NEG_INF)
        else:
            scores[batch["hist_row"], batch["hist_item"]] = NEG_INF
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

    def _chunk_rows(self) -> int:
        """Users of one full-sort chunk: its (users, n_items) f32 scores
        stay within ``SCORE_BYTES_BUDGET``."""
        return max(1, SCORE_BYTES_BUDGET // (4 * max(1, self.n_items)))

    def _score_chunks(self, batch: dict) -> list[dict]:
        """A host full-sort batch without its weight-0 padding rows, in
        user chunks of :meth:`_chunk_rows` users."""
        keep = np.flatnonzero(batch["weight"] > 0)
        rows = self._chunk_rows()
        return [{k: v[keep[lo:lo + rows]] for k, v in batch.items()}
                for lo in range(0, len(keep), rows)]

    def _place(self, arrays: dict) -> dict[str, torch.Tensor]:
        """:func:`to_device`, its bytes counted as ``h2d_bytes``."""
        out = to_device(arrays, self.device)
        trace.count("h2d_bytes", sum(t.nbytes for t in out.values()))
        return out

    def _uses_resident(self, loader, mode: str) -> bool:
        return (mode == "full" and not self.is_sequential
                and isinstance(loader, FullSortEvalLoader)
                and not self._use_dist_eval(mode))

    def _resident_chunks(self, loader: FullSortEvalLoader):
        """The chunks of :meth:`_score_chunks` over the loader's batches,
        each sliced from the loader's arrays resident on the device
        (placed at the first pass there)."""
        arr = loader.resident.get(self.device)
        if arr is None:
            indptr, rows, items = loader.history_csr()
            arr = loader.resident[self.device] = self._place({
                "user_id": loader.eval_users, "pos_items": loader.pos_mat,
                "pos_len": loader.pos_cnt, "hist_row": rows,
                "hist_item": items})
            arr["indptr"] = indptr   # host: slices without a device read
        indptr, n = arr["indptr"], len(loader.eval_users)
        step, rows = loader.batch_size, self._chunk_rows()
        for b0 in range(0, n, step):
            b1 = min(b0 + step, n)
            for lo in range(b0, b1, rows):
                hi = min(lo + rows, b1)
                h = slice(int(indptr[lo]), int(indptr[hi]))
                yield {"user_id": arr["user_id"][lo:hi],
                       "pos_items": arr["pos_items"][lo:hi],
                       "pos_len": arr["pos_len"][lo:hi],
                       "weight": torch.ones(hi - lo, device=self.device),
                       "hist_row": arr["hist_row"][h] - lo,
                       "hist_item": arr["hist_item"][h]}

    # -- public API -----------------------------------------------------

    def evaluate(self, params, extras, loader, mode: str = "full") -> dict:
        """Run a full evaluation pass; returns {metric@k: float}.  The
        pass is the span ``evaluate``, a factorized model's propagation
        the span ``propagate`` inside it (``utils/trace.py``)."""
        with trace.span("evaluate") as sp:
            out = self._evaluate(params, extras, loader, mode)
        self.last_seconds = sp.seconds
        return out

    def _evaluate(self, params, extras, loader, mode: str) -> dict:
        totals: dict[str, torch.Tensor] = {}
        with torch.no_grad():
            if self.is_sequential:
                def batch_sums(b):
                    return self._sequential_sums(params, extras, b, mode)
            elif self.model.factorized_eval:
                with trace.span("propagate"):
                    user_all, item_all = self.model.propagate(
                        params, self.model.consts, extras)
                item_block = (item_shard(item_all,
                                         axis_group(self.mesh, "tp"))
                              if self._use_dist_eval(mode) else None)

                def batch_sums(b):
                    u_e = user_all[b["user_id"]]
                    if item_block is not None:
                        return self._dist_full_sort_sums(u_e, item_block, b)
                    if mode == "full":
                        return self._full_sort_sums(
                            torch.matmul(u_e, item_all.T), b)
                    c_e = item_all[b["candidates"]]
                    return self._candidate_sums(
                        torch.einsum("bd,bcd->bc", u_e, c_e), b)
            else:
                def batch_sums(b):
                    scores = self.model.score_users_vs_all(params,
                                                           b["user_id"])
                    if mode == "full":
                        return self._full_sort_sums(scores, b)
                    return self._candidate_sums(
                        torch.gather(scores, 1, b["candidates"]), b)
            trace.count("passes", 1)
            resident = self._uses_resident(loader, mode)
            if resident:
                parts = self._resident_chunks(loader)
            else:
                chunked = not self.is_sequential and mode == "full"
                parts = (self._place(part) for batch in loader
                         for part in (self._score_chunks(batch) if chunked
                                      else [batch]))
            for part in parts:
                sums = batch_sums(part)
                trace.count("chunks", 1)
                trace.count("resident_chunks", int(resident))
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
