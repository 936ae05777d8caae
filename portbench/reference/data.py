"""The benchmark's own reading of its generated logs: token remap,
k-core filter, the general ratio split and the session augmentation
with its leave-one-out split, in plain NumPy.

These restate the semantics of RecBole's data pipeline, which the
program implements too, without any of the program's code: ids are
given in order of first appearance after the filter (PAD = 0); the
general split shuffles all rows with ``np.random.default_rng(seed)``
and gives each user ``tot - 2·floor(0.1·tot)`` rows for training (in
shuffled order), then ``floor(0.1·tot)`` each for validation and test
(RecBole's ``_calcu_split_ids``, one extra row to a split whose share is
below one row while the first can spare it); a session log yields one
sample per click after the first, the preceding ≤ ``max_len`` clicks
as its list, the last two samples of each session going to validation
and test.
"""

from __future__ import annotations

import numpy as np


def read_log(path: str, n_cols: int) -> np.ndarray:
    """(rows, n_cols) int64 table of an atomic file written by the
    benchmark's generators (integer tokens, one header line)."""
    with open(path, encoding="utf-8") as f:
        f.readline()
        flat = np.array(f.read().split(), dtype=np.int64)
    return flat.reshape(-1, n_cols)


def remap(tokens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(ids, vocab): ids 1.. in order of first appearance, PAD 0;
    ``vocab[id]`` is the token (``vocab[0]`` unused)."""
    uniq, first, inv = np.unique(tokens, return_index=True,
                                 return_inverse=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(1, len(uniq) + 1)
    vocab = np.zeros(len(uniq) + 1, np.int64)
    vocab[rank] = uniq
    return rank[inv], vocab


def kcore(users: np.ndarray, items: np.ndarray, k_user: int,
          k_item: int) -> np.ndarray:
    """Row mask of the iterated filter: every kept user has ≥ k_user
    and every kept item ≥ k_item kept rows."""
    keep = np.ones(len(users), bool)
    while True:
        _, ui, uc = np.unique(users[keep], return_inverse=True,
                              return_counts=True)
        _, ii, ic = np.unique(items[keep], return_inverse=True,
                              return_counts=True)
        ok = (uc[ui] >= k_user) & (ic[ii] >= k_item)
        if ok.all():
            return keep
        idx = np.flatnonzero(keep)
        keep[idx[~ok]] = False


def split_counts(tot: np.ndarray, ratios=(0.8, 0.1, 0.1)) -> np.ndarray:
    """(len(tot), 3) rows per split for each group size ``tot``."""
    s = sum(ratios)
    r = [x / s for x in ratios]
    cnt = np.stack([np.floor(x * tot) for x in r], axis=1).astype(np.int64)
    cnt[:, 0] = tot - cnt[:, 1:].sum(1)
    for i in range(1, len(r)):
        live = cnt[:, 0] > 1
        grant = live & (r[-i] * tot > 0) & (r[-i] * tot < 1)
        # a group whose first split fell to ≤ 1 grants nothing more
        cnt[grant, -i] += 1
        cnt[grant, 0] -= 1
        if not live.any():
            break
    return cnt


class GeneralLog:
    """A user–item log, remapped and split as the general models read
    it."""

    def __init__(self, path: str, seed: int):
        table = read_log(path, 2)
        self.user_tok, self.item_tok = table[:, 0], table[:, 1]
        self.users, self.user_vocab = remap(self.user_tok)
        self.items, self.item_vocab = remap(self.item_tok)
        self.n_users = len(self.user_vocab)
        self.n_items = len(self.item_vocab)
        n = len(self.users)
        perm = np.random.default_rng(seed).permutation(n)
        u = self.users[perm]
        order = np.argsort(u, kind="stable")
        us = u[order]
        start = np.searchsorted(us, us)           # first row of the group
        rank = np.arange(n) - start
        tot = np.bincount(us, minlength=self.n_users)
        cnt = split_counts(tot)
        c0, c1 = cnt[us, 0], cnt[us, 1]
        part = np.where(rank < c0, 0, np.where(rank < c0 + c1, 1, 2))
        self.split = np.empty(n, np.int64)
        self.split[perm[order]] = part

    def pairs(self, part: int) -> tuple[np.ndarray, np.ndarray]:
        m = self.split == part
        return self.users[m], self.items[m]

    def norm_adj(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """(src, dst, weight, n_nodes): the training graph over users and
        then items, both directions, weighted 1/sqrt(deg(src)·deg(dst))."""
        u, i = self.pairs(0)
        n = self.n_users + self.n_items
        src = np.concatenate([u, i + self.n_users])
        dst = np.concatenate([i + self.n_users, u])
        deg = np.bincount(dst, minlength=n).astype(np.float64)
        inv = np.zeros(n)
        inv[deg > 0] = deg[deg > 0] ** -0.5
        return src, dst, inv[src] * inv[dst], n


class SessionLog:
    """A session click log, filtered, remapped, augmented and split as
    the session models read it."""

    def __init__(self, path: str, max_len: int, k_core: int = 5):
        table = read_log(path, 3)
        keep = kcore(table[:, 0], table[:, 1], k_core, k_core)
        table = table[keep]
        self.sess, _ = remap(table[:, 0])
        self.items, self.item_vocab = remap(table[:, 1])
        self.n_items = len(self.item_vocab)
        order = np.lexsort((table[:, 2], self.sess))
        s, it = self.sess[order], self.items[order]
        n = len(s)
        start = np.searchsorted(s, s)
        pos = np.arange(n) - start                  # click's place
        length = np.bincount(s)[s]                  # its session's clicks
        tgt = np.flatnonzero(pos >= 1)
        lens = np.minimum(pos[tgt], max_len)
        j = np.arange(max_len)
        valid = j[None, :] < lens[:, None]
        at = np.where(valid, (tgt - lens)[:, None] + j[None, :], 0)
        self.seqs = np.where(valid, it[at], 0)
        self.lens = lens
        self.targets = it[tgt]
        back = length[tgt] - pos[tgt]             # 1 = last click
        self.part = np.where(back == 1, 2, np.where(back == 2, 1, 0))
        self.sess_of_sample = s[tgt]
        self.clicks = it                            # time-ordered
        self.click_start = start
        self.click_pos = pos

    def samples(self, part: int):
        m = self.part == part
        return self.seqs[m], self.lens[m], self.targets[m]
