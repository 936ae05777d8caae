"""A seeded synthetic interaction log of the LightGCN paper's Gowalla
shape (He et al., 2020, Table 1): 29,858 users × 40,981 items,
1,027,370 interactions, user activity lognormal, item popularity
Zipf-like.  ``chip_smoke.py`` trains on it.
"""

from __future__ import annotations

import os

import numpy as np

GOWALLA_SHAPE = {"n_users": 29858, "n_items": 40981, "n_inter": 1027370}


def write_gowalla_shape(root: str, name: str, seed: int, n_users: int,
                        n_items: int, n_inter: int, min_per_user: int = 10,
                        zipf_a: float = 0.8) -> str:
    """Write ``root/name/name.inter``: ``n_inter`` unique (user, item)
    pairs, every user with ≥ ``min_per_user`` and every item with ≥ 1
    interaction, user activity lognormal and item popularity Zipf-like
    (weight ∝ 1/rank^zipf_a)."""
    rng = np.random.default_rng(seed)
    act = rng.lognormal(0.0, 1.0, n_users)
    deg = min_per_user + rng.multinomial(
        n_inter - min_per_user * n_users, act / act.sum())
    assert deg.max() < n_items and deg.sum() == n_inter
    pop = 1.0 / np.arange(1, n_items + 1) ** zipf_a
    pop = (pop / pop.sum())[rng.permutation(n_items)]

    # every item once, each into a distinct user slot
    slots = rng.permutation(np.repeat(np.arange(n_users), deg))[:n_items]
    have = np.sort(slots.astype(np.int64) * n_items + np.arange(n_items))
    need = deg - np.bincount(slots, minlength=n_users)
    while need.sum() > 0:
        users = np.repeat(np.arange(n_users, dtype=np.int64), 2 * need + 2)
        key = users * n_items + rng.choice(n_items, len(users), p=pop)
        key = key[~np.isin(key, have)]
        key, first = np.unique(key, return_index=True)
        key = key[np.argsort(first)]          # draw order, not item order
        u = key // n_items
        order = np.argsort(u, kind="stable")
        u, key = u[order], key[order]
        rank = np.arange(len(u)) - np.searchsorted(u, u)
        take = rank < need[u]
        have = np.sort(np.concatenate([have, key[take]]))
        need -= np.bincount(u[take], minlength=n_users)
    have = have[rng.permutation(len(have))]
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{name}.inter")
    with open(path, "w", encoding="utf-8") as f:
        f.write("user_id:token\titem_id:token\n")
        f.write("\n".join(f"{u}\t{i}" for u, i in
                          zip((have // n_items).tolist(),
                              (have % n_items).tolist())))
        f.write("\n")
    return path
