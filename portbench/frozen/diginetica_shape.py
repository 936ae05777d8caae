"""A seeded synthetic session log of the reference's diginetica setting
(``results/sequential/diginetica.md:49-51``, after its 5-core filter):
72,014 sessions × 29,454 items × 580,490 interactions, about 8 items
per session.  Item popularity is Zipf-like; about 15 % of clicks
revisit an item seen earlier in the session; and about half of the
others follow a fixed next-item map (each item's planted successor), so
that a session model can learn transitions and Recall@10 can exceed 0.

Every session holds at least 5 interactions and every item at least 5,
so the setting's 5-core filter keeps all of them and the dataset has
exactly the shape above.

A frozen copy of ``recbole_gnn_tpu_torch/diag/diginetica_shape.py``
without its ``revisit_share`` reader: the benchmark's data must not
move when the program's copy does.
"""

from __future__ import annotations

import os

import numpy as np

DIGINETICA_SHAPE = {"n_sessions": 72014, "n_items": 29454,
                    "n_inter": 580490}


def write_diginetica_shape(root: str, name: str, seed: int, n_sessions: int,
                           n_items: int, n_inter: int, min_len: int = 5,
                           zipf_a: float = 0.8, p_revisit: float = 0.19,
                           p_next: float = 0.5) -> str:
    """Write ``root/name/name.inter`` (``session_id``, ``item_id``,
    ``timestamp``) and return its path.

    Session lengths: ``min_len`` plus a lognormal-weighted share of the
    rest.  Each click is, in this order of precedence: one of the
    ``min_len`` reserved slots of every item (so each item occurs at
    least ``min_len`` times), a revisit of an earlier click of the
    session (``p_revisit``), the planted successor of the previous
    click (``p_next``), or a Zipf draw (weight ∝ 1/rank^zipf_a)."""
    rng = np.random.default_rng(seed)
    extra = n_inter - min_len * n_sessions
    if extra < 0 or min_len * n_items > n_inter:
        raise ValueError("shape cannot hold min_len clicks per session "
                         "and per item")
    act = rng.lognormal(0.0, 0.6, n_sessions)
    lens = min_len + rng.multinomial(extra, act / act.sum())
    L = int(lens.max())
    valid = np.arange(L)[None, :] < lens[:, None]

    pop = 1.0 / np.arange(1, n_items + 1) ** zipf_a
    pop = (pop / pop.sum())[rng.permutation(n_items)]
    base = rng.choice(n_items, size=(n_sessions, L), p=pop)
    succ = rng.permutation(n_items)
    # min_len reserved clicks of every item, at random valid positions
    flat = np.flatnonzero(valid.ravel())
    reserved = np.full(n_sessions * L, -1, np.int64)
    reserved[rng.choice(flat, min_len * n_items, replace=False)] = \
        np.repeat(np.arange(n_items), min_len)
    reserved = reserved.reshape(n_sessions, L)
    u_rev = rng.random((n_sessions, L))
    u_next = rng.random((n_sessions, L))
    back = rng.random((n_sessions, L))

    items = np.zeros((n_sessions, L), np.int64)
    rows = np.arange(n_sessions)
    for j in range(L):
        col = base[:, j]
        if j:
            col = np.where(u_next[:, j] < p_next, succ[items[:, j - 1]], col)
            earlier = items[rows, (back[:, j] * j).astype(np.int64)]
            col = np.where(u_rev[:, j] < p_revisit, earlier, col)
        items[:, j] = np.where(reserved[:, j] >= 0, reserved[:, j], col)

    sess = np.repeat(np.arange(n_sessions), lens)
    item_tok = items[valid] + 1
    # sessions in time order, clicks 1 s apart inside a session
    ts = (1_400_000_000 + sess.astype(np.int64) * 3600
          + (np.arange(len(sess)) - np.repeat(np.cumsum(lens) - lens, lens)))
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{name}.inter")
    with open(path, "w", encoding="utf-8") as f:
        f.write("session_id:token\titem_id:token\ttimestamp:float\n")
        f.write("\n".join(f"{s}\t{i}\t{t}" for s, i, t in
                          zip(sess.tolist(), item_tok.tolist(), ts.tolist())))
        f.write("\n")
    return path

