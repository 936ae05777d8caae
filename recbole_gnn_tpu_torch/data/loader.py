"""Batch loaders — static-shape numpy batch dicts.

Numpy copy of the general-model loaders of
``recbole_gnn_tpu/data/loader.py`` (``TrainLoader``,
``FullSortEvalLoader``, ``NegSampleEvalLoader``): the same seeds give
the same batches, element for element, in both packages.  Every batch
of an epoch has the same shapes — the last one is padded by repeating
row 0 with a ``weight`` of 0 — so losses and metric sums ignore the
padding.  The sequential loaders come with the session slice.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from recbole_gnn_tpu_torch.data.sampler import (
    PopularityNegativeSampler, UniformNegativeSampler)


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
            pad = np.repeat(v[:1], batch_size - n, axis=0)
            v = np.concatenate([v, pad], axis=0)
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
    fresh negative sampling — the general-model train path."""

    def __init__(self, dataset, config, seed_offset: int = 0):
        self.users, self.items = dataset.user_item_arrays()
        self.n_users, self.n_items = dataset.n_users, dataset.n_items
        self.batch_size = int(config.get("train_batch_size", 2048))
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
        perm = rng.permutation(len(self.users))
        users, items = self.users[perm], self.items[perm]
        negs = (self.sampler.sample(users, self.neg_num, rng)
                if self.neg_num else None)
        for lo in range(0, len(users), self.batch_size):
            hi = min(lo + self.batch_size, len(users))
            arrays = {"user_id": users[lo:hi], "item_id": items[lo:hi]}
            if negs is not None:
                nb = negs[lo:hi]
                arrays["neg_item_id"] = nb[:, 0] if self.neg_num == 1 else nb
            yield _pad_batch(arrays, self.batch_size)


class FullSortEvalLoader:
    """Per-user eval batches: history indices (to mask) + positives.

    history = positives of *earlier* phases; pos = this split's items —
    the [recbole] full-sort convention (SURVEY.md §3.3)."""

    def __init__(self, eval_dataset, history_datasets, config):
        self.n_items = eval_dataset.n_items
        self.batch_size = max(1, int(config.get("eval_batch_size", 4096)))
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
        self.batch_size = max(1, int(config.get("eval_batch_size", 4096)))
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
