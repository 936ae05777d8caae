"""A seeded synthetic social log of the HetRec 2011 LastFM statistics
that ``examples/lastfm.yaml`` reproduces (the reference's
``results/social/lastfm.md`` setting): 1,892 users × 17,632 artists,
92,834 user-artist pairs (each user's top artists, at most 50 each,
no pair twice) and 12,717 undirected friend pairs, which the social
datasets' undirected duplication makes 25,434 net edges.

Artist popularity is Zipf-like with a long tail: every artist is some
user's, and most of the rest of the pairs come from a Zipf draw.
Friendship degrees are lognormal-skewed, and each user takes part of
their artists from their friends' lists (``p_friend``), so friends
share artists and MHCN's social and joint motifs are not empty.
Nothing is downloaded.  ``chip_smoke.py`` trains the social models on it
at ``examples/lastfm.yaml``'s settings.
"""

from __future__ import annotations

import os

import numpy as np

LASTFM_SHAPE = {"n_users": 1892, "n_items": 17632, "n_inter": 92834,
                "n_friend_pairs": 12717, "max_per_user": 50}


def write_lastfm_shape(root: str, name: str, seed: int, n_users: int,
                       n_items: int, n_inter: int, n_friend_pairs: int,
                       max_per_user: int, zipf_a: float = 1.0,
                       p_friend: float = 0.3) -> tuple[str, str]:
    """Write ``root/name/name.inter`` (``user_id``, ``item_id``) and
    ``root/name/name.net`` (``source_id``, ``target_id``, each friend
    pair once) and return their paths."""
    if not n_items <= n_inter <= n_users * max_per_user:
        raise ValueError("shape cannot hold every artist once and at most "
                         "max_per_user artists per user")
    rng = np.random.default_rng(seed)
    # per-user list lengths: max_per_user for most, the deficit spread
    counts = np.full(n_users, max_per_user, np.int64)
    deficit = n_users * max_per_user - n_inter
    while deficit:
        take = rng.choice(np.flatnonzero(counts > 1),
                          min(deficit, n_users), replace=False)
        counts[take] -= 1
        deficit -= len(take)

    # friend pairs: endpoints drawn by lognormal activity, no self pair,
    # no pair twice (in either direction)
    act = rng.lognormal(0.0, 1.0, n_users)
    act /= act.sum()
    pairs: set[tuple[int, int]] = set()
    while len(pairs) < n_friend_pairs:
        need = n_friend_pairs - len(pairs)
        a = rng.choice(n_users, 2 * need, p=act)
        b = rng.choice(n_users, 2 * need, p=act)
        for u, v in zip(a.tolist(), b.tolist()):
            if u != v and len(pairs) < n_friend_pairs:
                pairs.add((min(u, v), max(u, v)))
    pairs = sorted(pairs)
    friends = [[] for _ in range(n_users)]
    for u, v in pairs:
        friends[u].append(v)
        friends[v].append(u)

    pop = 1.0 / np.arange(1, n_items + 1) ** zipf_a
    pop = (pop / pop.sum())[rng.permutation(n_items)]
    # every artist once, on a random user slot; the rest of each list
    # from friends' lists (p_friend) or a Zipf draw
    lists = [set() for _ in range(n_users)]
    slots = np.repeat(np.arange(n_users), counts)
    for u, i in zip(slots[rng.permutation(len(slots))[:n_items]].tolist(),
                    rng.permutation(n_items).tolist()):
        lists[u].add(i)
    zipf = iter(rng.choice(n_items, size=8 * n_inter, p=pop).tolist())
    for u in rng.permutation(n_users).tolist():
        own = lists[u]
        pool = [i for f in friends[u] for i in lists[f] if i not in own]
        while len(own) < counts[u]:
            if pool and rng.random() < p_friend:
                own.add(pool[int(rng.integers(len(pool)))])
            else:
                own.add(next(zipf))
    users = np.repeat(np.arange(n_users), [len(s) for s in lists])
    items = np.concatenate([np.fromiter(sorted(s), np.int64, len(s))
                            for s in lists])
    if len(users) != n_inter or len(np.unique(items)) != n_items:
        raise AssertionError("lastfm shape: generation missed its counts")
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    inter = os.path.join(d, f"{name}.inter")
    with open(inter, "w") as f:
        f.write("user_id:token\titem_id:token\n")
        f.write("\n".join(f"{u + 1}\t{i + 1}" for u, i in
                          zip(users.tolist(), items.tolist())))
        f.write("\n")
    net = os.path.join(d, f"{name}.net")
    with open(net, "w") as f:
        f.write("source_id:token\ttarget_id:token\n")
        f.write("\n".join(f"{u + 1}\t{v + 1}" for u, v in pairs))
        f.write("\n")
    return inter, net


def shared_artist_share(inter: str, net: str) -> float:
    """The share of friend pairs that have an artist in common."""
    u, i = np.loadtxt(inter, dtype=np.int64, skiprows=1, unpack=True)
    s, t = np.loadtxt(net, dtype=np.int64, skiprows=1, unpack=True)
    by_user: dict[int, set] = {}
    for a, b in zip(u.tolist(), i.tolist()):
        by_user.setdefault(a, set()).add(b)
    shared = sum(bool(by_user[a] & by_user[b])
                 for a, b in zip(s.tolist(), t.tolist()))
    return shared / len(s)
