"""Seeded uniform negative sampling.

Numpy copy of ``recbole_gnn_tpu/data/sampler.py`` (the port keeps its
own, so that the two draw the same negatives from the same
``np.random.Generator``).  Equivalent of [recbole]'s Sampler machinery (used via
`create_samplers` in the reference's data_preparation, SURVEY.md §3.1):
uniform draws over [1, n_items), redrawing while the candidate is in
the user's *used* set for the phase (train used = train positives;
valid used = train+valid; test used = train+valid+test).

Vectorized: membership tests are searchsorted lookups on a sorted
(uid·n_items + iid) key array — no per-user Python sets.
"""

from __future__ import annotations

import numpy as np


class UniformNegativeSampler:

    def __init__(self, users: np.ndarray, items: np.ndarray,
                 n_users: int, n_items: int):
        """``users``/``items`` enumerate the used (positive) pairs."""
        self.n_users = n_users
        self.n_items = n_items
        keys = users.astype(np.int64) * n_items + items.astype(np.int64)
        self.used_keys = np.sort(np.unique(keys))

    def _is_used(self, users: np.ndarray, cand: np.ndarray) -> np.ndarray:
        keys = users.astype(np.int64) * self.n_items + cand.astype(np.int64)
        pos = np.searchsorted(self.used_keys, keys)
        pos = np.minimum(pos, len(self.used_keys) - 1)
        return self.used_keys[pos] == keys if len(self.used_keys) else \
            np.zeros(len(keys), dtype=bool)

    def _draw(self, size: int, rng: np.random.Generator) -> np.ndarray:
        return rng.integers(1, self.n_items, size=size, dtype=np.int64)

    def sample(self, users: np.ndarray, num: int,
               rng: np.random.Generator, max_tries: int = 100) -> np.ndarray:
        """(len(users), num) negatives ∈ [1, n_items) avoiding used pairs.

        After ``max_tries`` redraw rounds, remaining collisions are kept
        (matches RecBole's bounded-retry behavior for dense users)."""
        flat_users = np.repeat(users, num)
        cand = self._draw(len(flat_users), rng)
        bad = self._is_used(flat_users, cand)
        tries = 0
        while bad.any() and tries < max_tries:
            cand[bad] = self._draw(int(bad.sum()), rng)
            bad = self._is_used(flat_users, cand)
            tries += 1
        return cand.reshape(len(users), num)


class PopularityNegativeSampler(UniformNegativeSampler):
    """Negatives drawn ∝ interaction frequency — the [recbole]
    'popularity' distribution backing the ``popN`` eval mode: each draw
    picks a uniformly random *interaction* and takes its item, so an
    item's probability is proportional to its count."""

    def __init__(self, users: np.ndarray, items: np.ndarray,
                 n_users: int, n_items: int):
        super().__init__(users, items, n_users, n_items)
        self.pool = np.asarray(items, dtype=np.int64)

    def _draw(self, size: int, rng: np.random.Generator) -> np.ndarray:
        return self.pool[rng.integers(0, len(self.pool), size=size)]
