"""Batch loaders — static-shape numpy batch dicts.

Numpy copy of ``recbole_gnn_tpu/data/loader.py``: the general-model
loaders (``TrainLoader``, ``FullSortEvalLoader``,
``NegSampleEvalLoader``) and the sequential ones
(``SequentialTrainLoader`` with its optional BPR negatives,
``SequentialFullSortEvalLoader``, ``SequentialNegSampleEvalLoader``):
the same seeds give the same batches, element for element, in both
packages.  Every batch of an epoch has the same shapes — the last one
is padded by repeating row 0 with a ``weight`` of 0 — so losses and
metric sums ignore the padding.  A session batch is a slice of the
dataset's padded session (and session-graph) arrays.

The two training loaders open the same spans, ``shuffle`` and
``batch`` (their docstrings say what each covers); the evaluation
loaders open none: the evaluator's spans time them.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from recbole_gnn_tpu_torch.data.sampler import (
    PopularityNegativeSampler, UniformNegativeSampler)
from recbole_gnn_tpu_torch.utils import trace


def _eval_sampler_cls(distribution: str):
    return (PopularityNegativeSampler if distribution == "pop"
            else UniformNegativeSampler)


Batch = dict[str, np.ndarray]


def _pad_batch(arrays: Batch, batch_size: int) -> Batch:
    """Pad a short (final) batch to ``batch_size`` by repeating row 0,
    with weight 0 for the padding rows."""
    n = len(next(iter(arrays.values())))
    out = {}
    w = np.zeros(batch_size, dtype=np.float32)
    w[:n] = 1.0
    for k, v in arrays.items():
        if n < batch_size:
            # one pass over the padded array (a large eval_batch_size
            # pads millions of rows)
            full = np.empty((batch_size,) + v.shape[1:], dtype=v.dtype)
            full[:n] = v
            full[n:] = v[:1]
            v = full
        out[k] = v
    out["weight"] = w
    return out


def _padded_user_rows(users: np.ndarray, items: np.ndarray,
                      row_of: np.ndarray, n_rows: int,
                      min_width: int = 1
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(mat, counts): per eval-row padded item lists, fully vectorized
    (searchsorted/bincount style — no per-user Python; at 100k+ users
    the dict/loop version costs minutes of host time per eval)."""
    sel = row_of[users] >= 0
    users, items = users[sel], items[sel]
    rows = row_of[users]
    order = np.argsort(rows, kind="stable")
    rows, items = rows[order], items[order]
    bounds = np.searchsorted(rows, np.arange(n_rows + 1))
    cnt = np.diff(bounds)
    width = max(int(cnt.max(initial=0)), min_width)
    mat = np.zeros((n_rows, width), dtype=np.int64)
    col = np.arange(len(rows)) - np.repeat(bounds[:-1], cnt)
    mat[rows, col] = items
    return mat, cnt.astype(np.int64)


class TrainLoader:
    """Pairwise (user, pos, neg·k) batches with per-epoch reshuffle +
    fresh negative sampling — the general-model train path.

    Spans (``utils/trace.py``; under ``fit/epoch/`` inside ``fit``):
    ``shuffle`` (the epoch's permutation and index), the sampler's
    ``sample`` (the epoch's negatives, at its first batch) and one
    ``batch`` a batch (its slice and padding).  Each closes before the
    ``yield``, as :class:`SequentialTrainLoader`'s do."""

    def __init__(self, dataset, config, seed_offset: int = 0):
        self.users, self.items = dataset.user_item_arrays()
        self.n_users, self.n_items = dataset.n_users, dataset.n_items
        self.batch_size = int(config.or_default("train_batch_size", 2048))
        neg_args = config["train_neg_sample_args"]
        self.neg_num = int((neg_args or {}).get("sample_num", 1)) if neg_args else 0
        self.sampler = UniformNegativeSampler(
            self.users, self.items, self.n_users, self.n_items)
        self.seed = int(config.get("seed", 2020)) + seed_offset
        self.epoch = 0

    def __len__(self):
        return -(-len(self.users) // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng((self.seed, self.epoch))
        self.epoch += 1
        with trace.span("shuffle"):
            perm = rng.permutation(len(self.users))
            users, items = self.users[perm], self.items[perm]
        negs = (self.sampler.sample(users, self.neg_num, rng)
                if self.neg_num else None)
        for lo in range(0, len(users), self.batch_size):
            with trace.span("batch"):
                hi = min(lo + self.batch_size, len(users))
                arrays = {"user_id": users[lo:hi], "item_id": items[lo:hi]}
                if negs is not None:
                    nb = negs[lo:hi]
                    arrays["neg_item_id"] = (nb[:, 0] if self.neg_num == 1
                                             else nb)
                batch = _pad_batch(arrays, self.batch_size)
            yield batch


class FullSortEvalLoader:
    """Per-user eval batches: history indices (to mask) + positives.

    history = positives of *earlier* phases; pos = this split's items —
    the [recbole] full-sort convention (SURVEY.md §3.3).

    The arrays are fixed once built.  Iterating yields numpy batches of
    ``eval_batch_size`` users, the history as the 0-padded
    ``hist_mat`` rows.  The evaluator's full sort instead places the
    arrays on its device once and slices every later pass there
    (``eval/evaluator.py``): ``eval_users``, ``pos_mat``, ``pos_cnt``
    and the history as CSR (:meth:`history_csr`, one entry a real
    history item, not the padded matrix), cached in :attr:`resident`
    by device for the loader's life."""

    def __init__(self, eval_dataset, history_datasets, config):
        self.n_items = eval_dataset.n_items
        self.batch_size = max(1, int(config.or_default("eval_batch_size",
                                                          4096)))
        n_users = eval_dataset.n_users
        e_users, e_items = eval_dataset.user_item_arrays()
        self.eval_users = np.unique(e_users).astype(np.int64)
        row_of = np.full(n_users, -1, dtype=np.int64)
        row_of[self.eval_users] = np.arange(len(self.eval_users))
        self.pos_mat, self.pos_cnt = _padded_user_rows(
            e_users, e_items, row_of, len(self.eval_users))
        h_users = [np.zeros(0, np.int64)]
        h_items = [np.zeros(0, np.int64)]
        for ds in history_datasets:
            u, i = ds.user_item_arrays()
            h_users.append(np.asarray(u, np.int64))
            h_items.append(np.asarray(i, np.int64))
        self.hist_mat, self.hist_cnt = _padded_user_rows(
            np.concatenate(h_users), np.concatenate(h_items),
            row_of, len(self.eval_users))
        # {device: the arrays the evaluator placed there}
        self.resident: dict = {}

    def history_csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(indptr, rows, items): the history without its padding, row
        by row — row r's items are ``items[indptr[r]:indptr[r + 1]]``,
        each entry's row in ``rows``."""
        indptr = np.zeros(len(self.hist_cnt) + 1, dtype=np.int64)
        np.cumsum(self.hist_cnt, out=indptr[1:])
        real = (np.arange(self.hist_mat.shape[1])[None, :]
                < self.hist_cnt[:, None])
        rows = np.repeat(np.arange(len(self.hist_cnt), dtype=np.int64),
                         self.hist_cnt)
        return indptr, rows, self.hist_mat[real]

    def __len__(self):
        return -(-len(self.eval_users) // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        B = self.batch_size
        for lo in range(0, len(self.eval_users), B):
            sl = slice(lo, lo + B)
            yield _pad_batch(
                {"user_id": self.eval_users[sl],
                 "pos_items": self.pos_mat[sl],
                 "pos_len": self.pos_cnt[sl],
                 "history_items": self.hist_mat[sl]}, B)


class NegSampleEvalLoader:
    """uniN eval (e.g. uni100): per eval user, positives + N sampled
    negatives per positive form the candidate list; ranking is within
    that list (reference: CustomizedNegSampleEvalDataLoader,
    dataloader.py:22-52)."""

    def __init__(self, eval_dataset, history_datasets, config,
                 sample_num: int, distribution: str = "uni"):
        self.n_items = eval_dataset.n_items
        self.sample_num = sample_num
        self.batch_size = max(1, int(config.or_default("eval_batch_size",
                                                          4096)))
        self.seed = int(config.get("seed", 2020))
        n_users = eval_dataset.n_users
        e_users, e_items = eval_dataset.user_item_arrays()
        self.eval_users = np.unique(e_users).astype(np.int64)
        row_of = np.full(n_users, -1, dtype=np.int64)
        row_of[self.eval_users] = np.arange(len(self.eval_users))
        self.pos_mat, self.pos_cnt = _padded_user_rows(
            e_users, e_items, row_of, len(self.eval_users))
        # used set for sampling: all phases up to and incl. this one
        users_all, items_all = [], []
        for ds in list(history_datasets) + [eval_dataset]:
            u, i = ds.user_item_arrays()
            users_all.append(u)
            items_all.append(i)
        self.sampler = _eval_sampler_cls(distribution)(
            np.concatenate(users_all), np.concatenate(items_all),
            eval_dataset.n_users, eval_dataset.n_items)
        self.max_pos = self.pos_mat.shape[1]
        self.n_cand = self.max_pos * (1 + sample_num)

    def __len__(self):
        return -(-len(self.eval_users) // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng((self.seed, 77))
        B = self.batch_size
        for lo in range(0, len(self.eval_users), B):
            sl = slice(lo, lo + B)
            users = self.eval_users[sl]
            n = len(users)
            pos = self.pos_mat[sl]
            pos_len = self.pos_cnt[sl]
            # one flat draw for every (user, positive) pair in the
            # batch, then scattered into candidate rows (no per-user
            # Python loop; same per-pair sampler semantics)
            flat_users = np.repeat(users, pos_len)
            negs = self.sampler.sample(
                flat_users, self.sample_num, rng)          # (pairs, N)
            cand = np.zeros((n, self.n_cand), dtype=np.int64)
            cand_len = pos_len * (1 + self.sample_num)
            rows_cols = np.arange(self.max_pos)[None, :]
            valid = rows_cols < pos_len[:, None]
            cand[:, :self.max_pos][valid] = pos[valid]
            # negatives start after each row's positives
            pair_row = np.repeat(np.arange(n), pos_len)
            within = (np.arange(len(flat_users))
                      - np.repeat(np.cumsum(pos_len) - pos_len, pos_len))
            ncols = (pos_len[pair_row][:, None]
                     + within[:, None] * self.sample_num
                     + np.arange(self.sample_num)[None, :])
            cand[pair_row[:, None], ncols] = negs
            yield _pad_batch(
                {"user_id": users, "candidates": cand, "cand_len": cand_len,
                 "pos_items": pos, "pos_len": pos_len}, B)


# -- sequential ---------------------------------------------------------

def _session_batch(dataset, rows: np.ndarray) -> Batch:
    b: Batch = {
        "user_id": dataset.inter[dataset.uid_field][rows],
        "item_id": dataset.inter[dataset.iid_field][rows],
        "item_seq": dataset.inter[dataset.item_list_field][rows],
        "item_seq_len": dataset.inter[dataset.item_length_field][rows],
    }
    graphs = getattr(dataset, "session_graphs", None)
    if graphs is not None:
        for k, v in graphs.items():
            b[k] = v[rows]
    return b


class SequentialTrainLoader:
    """Shuffled batches of padded session rows (+ graph arrays).  The
    sequential family trains without negative sampling (CE over the
    catalog — reference sequential_base.yaml); with
    ``train_neg_sample_args`` each batch draws its own negatives.

    Spans (``utils/trace.py``; under ``fit/epoch/`` inside ``fit``):
    ``shuffle`` (the epoch's permutation) and one ``batch`` a batch
    (its rows' slices of the session and session-graph arrays, the
    sampler's ``sample`` nested where negatives are drawn, and the
    padding).  Each closes before the ``yield``, as
    :class:`TrainLoader`'s do.  Counters under ``batch``: ``rows`` (real
    rows), ``padded_rows`` (the rows the padding adds), ``positions``
    (the clicks of the real rows, Σ ``item_seq_len``) and ``slots``
    (every row's ``MAX_ITEM_LIST_LENGTH`` positions, padding rows
    included): ``positions / slots`` is the share of the batch's dense
    (B, L) work that holds a click."""

    def __init__(self, dataset, config, seed_offset: int = 0):
        self.dataset = dataset
        self.n = dataset.inter_num
        self.batch_size = int(config.or_default("train_batch_size", 2048))
        self.seed = int(config.get("seed", 2020)) + seed_offset
        self.epoch = 0
        neg_args = config["train_neg_sample_args"]
        self.neg_num = int((neg_args or {}).get("sample_num", 1)) if neg_args else 0
        if self.neg_num:
            users, items = dataset.user_item_arrays()
            self.sampler = UniformNegativeSampler(
                users, items, dataset.n_users, dataset.n_items)

    def __len__(self):
        return -(-self.n // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng((self.seed, self.epoch))
        self.epoch += 1
        with trace.span("shuffle"):
            perm = rng.permutation(self.n)
        for lo in range(0, self.n, self.batch_size):
            with trace.span("batch"):
                rows = perm[lo:lo + self.batch_size]
                b = _session_batch(self.dataset, rows)
                if self.neg_num:
                    negs = self.sampler.sample(b["user_id"], self.neg_num,
                                               rng)
                    b["neg_item_id"] = (negs[:, 0] if self.neg_num == 1
                                        else negs)
                batch = _pad_batch(b, self.batch_size)
                trace.count("rows", len(rows))
                trace.count("padded_rows", self.batch_size - len(rows))
                trace.count("positions", b["item_seq_len"].sum())
                trace.count("slots", batch["item_seq"].size)
            yield batch


class SequentialFullSortEvalLoader:
    """Full-sort eval for sequential models: each row is one session,
    the single positive is its target; no history masking ([recbole]
    skips uid2history for sequential full-sort)."""

    def __init__(self, dataset, config):
        self.dataset = dataset
        self.n = dataset.inter_num
        self.n_items = dataset.n_items
        self.batch_size = max(1, int(config.or_default("eval_batch_size", 4096)))

    def __len__(self):
        return -(-self.n // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        for lo in range(0, self.n, self.batch_size):
            rows = np.arange(lo, min(lo + self.batch_size, self.n))
            b = _session_batch(self.dataset, rows)
            b["pos_items"] = b["item_id"].reshape(-1, 1).astype(np.int64)
            b["pos_len"] = np.ones(len(rows), dtype=np.int64)
            yield _pad_batch(b, self.batch_size)


class SequentialNegSampleEvalLoader:
    """uniN eval for sequential: target + N sampled negatives per row."""

    def __init__(self, dataset, history_datasets, config,
                 sample_num: int, distribution: str = "uni"):
        self.dataset = dataset
        self.n = dataset.inter_num
        self.sample_num = sample_num
        self.batch_size = max(1, int(config.or_default("eval_batch_size", 4096)))
        self.seed = int(config.get("seed", 2020))
        users_all, items_all = [], []
        for ds in list(history_datasets) + [dataset]:
            u, i = ds.user_item_arrays()
            users_all.append(u)
            items_all.append(i)
        self.sampler = _eval_sampler_cls(distribution)(
            np.concatenate(users_all), np.concatenate(items_all),
            dataset.n_users, dataset.n_items)

    def __len__(self):
        return -(-self.n // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng((self.seed, 77))
        for lo in range(0, self.n, self.batch_size):
            rows = np.arange(lo, min(lo + self.batch_size, self.n))
            b = _session_batch(self.dataset, rows)
            users = b["user_id"]
            pos = b["item_id"].astype(np.int64)
            negs = self.sampler.sample(users, self.sample_num, rng)
            b["candidates"] = np.concatenate([pos.reshape(-1, 1), negs], axis=1)
            b["cand_len"] = np.full(len(rows), 1 + self.sample_num, np.int64)
            b["pos_items"] = pos.reshape(-1, 1)
            b["pos_len"] = np.ones(len(rows), dtype=np.int64)
            yield _pad_batch(b, self.batch_size)
