"""Case-study helpers: score chosen users against the full catalog on a
trained model (port of ``recbole_gnn_tpu/utils/case_study.py``, the
[recbole] ``full_sort_scores`` / ``full_sort_topk`` API).

A factorised model propagates once and scores the users by one
(B, d) × (d, n_items) product; NeuMF scores through
``score_users_vs_all``.  The PAD item and, when a history is given,
each user's items are masked to ``NEG_INF``, as in evaluation and
serving.  The scores live on the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from recbole_gnn_tpu_torch.ops.topk import NEG_INF, masked_topk
from recbole_gnn_tpu_torch.utils.enums import ModelType


def _history_rows(uids: np.ndarray, history: dict | None) -> np.ndarray | None:
    """(B, max_hist) item ids of each user's history, 0-padded; None
    without a history."""
    if history is None:
        return None
    rows = [np.asarray(history.get(int(u), ()), dtype=np.int64) for u in uids]
    width = max((len(r) for r in rows), default=0)
    if width == 0:
        return None
    out = np.zeros((len(rows), width), dtype=np.int64)
    for b, r in enumerate(rows):
        out[b, :len(r)] = r
    return out


def full_sort_scores(uid_series, model, params, extras,
                     history: dict | None = None) -> torch.Tensor:
    """(B, n_items) f32 scores of each user (internal ids) against the
    catalog; ``history``: {uid: item ids} to mask (e.g. the train
    split's ``history_matrix()``).  Sequential models score sessions,
    not user ids, and raise."""
    if model.model_type == ModelType.SEQUENTIAL:
        raise ValueError(
            "case_study full-sort scoring is defined for general/social "
            "models; sequential models score sessions via full_scores")
    uids_np = np.atleast_1d(np.asarray(uid_series, dtype=np.int64))
    uids = torch.from_numpy(uids_np).to(model.device)
    with torch.no_grad():
        if model.factorized_eval:
            user_all, item_all = model.propagate(params, model.consts, extras)
            scores = torch.matmul(user_all[uids], item_all.T)
        else:
            scores = model.score_users_vs_all(params, uids)
    scores = scores.clone()
    scores[:, 0] = NEG_INF                          # PAD item
    hist = _history_rows(uids_np, history)
    if hist is not None:
        # the 0-padding of a short history only masks PAD again
        scores.scatter_(1, torch.from_numpy(hist).to(scores.device), NEG_INF)
    return scores


def full_sort_topk(uid_series, model, params, extras, k: int,
                   history: dict | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` (scores, item ids) per user."""
    return masked_topk(full_sort_scores(uid_series, model, params, extras,
                                        history), k)


def topk_items_by_token(user_tokens, model, params, extras, dataset,
                        k: int, mask_history: bool = True
                        ) -> dict[str, list[str]]:
    """{user token: [item tokens]} top-k by external tokens; ``dataset``
    gives the vocabularies and, with ``mask_history``, the items to
    mask."""
    t2i = dataset.field2token_id[dataset.uid_field]
    uids = np.asarray([t2i[str(t)] for t in user_tokens], dtype=np.int64)
    history = dataset.history_matrix() if mask_history else None
    _, idx = full_sort_topk(uids, model, params, extras, k, history)
    i2t = dataset.field2id_token[dataset.iid_field]
    return {str(tok): [str(i2t[j]) for j in row]
            for tok, row in zip(user_tokens, idx.cpu().numpy())}
