"""Seeded uniform negative sampling.

Numpy copy of ``recbole_gnn_tpu/data/sampler.py`` (the port keeps its
own, so that the two draw the same negatives from the same
``np.random.Generator``).  Equivalent of [recbole]'s Sampler machinery (used via
`create_samplers` in the reference's data_preparation, SURVEY.md §3.1):
uniform draws over [1, n_items), redrawing while the candidate is in
the user's *used* set for the phase (train used = train positives;
valid used = train+valid; test used = train+valid+test).

Vectorized, with no per-user Python sets: a pair (u, i) is the key
u·n_items + i, and a membership test reads that key's bit in a bit set
of the used keys, or, where the bit set would pass
:data:`BITSET_MAX_BYTES`, is a searchsorted lookup on the sorted keys.
A redraw round tests only the pairs it drew again, so the draws, and
the negatives, are those of the JAX package's sampler.
"""

from __future__ import annotations

import numpy as np

from recbole_gnn_tpu_torch.utils import trace

# the largest used-pair bit set (ceil(n_users·n_items / 8) bytes) a
# sampler builds, to bound its host memory: the LightGCN paper's
# Gowalla (153 MB), Yelp2018 and Amazon-Book (603 MB) fit; a larger
# shape searches the sorted keys instead
BITSET_MAX_BYTES = 1 << 30


class UniformNegativeSampler:

    def __init__(self, users: np.ndarray, items: np.ndarray,
                 n_users: int, n_items: int):
        """``users``/``items`` enumerate the used (positive) pairs."""
        self.n_users = n_users
        self.n_items = n_items
        keys = np.unique(users.astype(np.int64) * n_items
                         + items.astype(np.int64))
        n_bytes = -(-n_users * n_items // 8)
        self.used_bits = self.used_keys = None
        if n_bytes <= BITSET_MAX_BYTES:
            # the keys are sorted, so each byte's keys are one run: OR
            # their bits together and store each byte once
            byte = keys >> 3
            first = np.flatnonzero(np.diff(byte, prepend=-1))
            self.used_bits = np.zeros(n_bytes, dtype=np.uint8)
            self.used_bits[byte[first]] = np.bitwise_or.reduceat(
                (1 << (keys & 7)).astype(np.uint8), first)
        else:
            self.used_keys = keys

    def _is_used(self, users: np.ndarray, cand: np.ndarray) -> np.ndarray:
        keys = users.astype(np.int64) * self.n_items + cand.astype(np.int64)
        if self.used_bits is not None:
            return (self.used_bits[keys >> 3] >> (keys & 7) & 1).astype(bool)
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
        (matches RecBole's bounded-retry behavior for dense users).

        The call is the span ``sample``, with three counters
        (``utils/trace.py``): ``checked``, the pairs tested against the
        used set over every round, ``bitset_tests``, those of them
        tested through the bit set, and ``drawn``, the negatives
        returned."""
        with trace.span("sample"):
            flat_users = np.repeat(users, num)
            cand = self._draw(len(flat_users), rng)
            bad = np.flatnonzero(self._is_used(flat_users, cand))
            checked = len(cand)
            tries = 0
            while len(bad) and tries < max_tries:
                cand[bad] = self._draw(len(bad), rng)
                checked += len(bad)
                bad = bad[self._is_used(flat_users[bad], cand[bad])]
                tries += 1
            trace.count("checked", checked)
            trace.count("bitset_tests",
                        checked if self.used_bits is not None else 0)
            trace.count("drawn", len(cand))
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
