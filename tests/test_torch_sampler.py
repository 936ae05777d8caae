"""The port's negative samplers (``recbole_gnn_tpu_torch/data/sampler.py``)
against the JAX package's, draw for draw.

Each shape takes one membership path by its size alone: ``small`` holds
its used pairs in the bit set, ``wide`` (100,000 users × 100,000 items)
and ``tall`` (300,000,000 users × 40 items) need more than
``BITSET_MAX_BYTES`` for one and take the sorted keys.  In ``small`` and
``tall`` one user has used every item, so that user's draws collide
for ``max_tries`` rounds and are kept; every other negative is an
unused pair.
"""

import numpy as np
import pytest

from recbole_gnn_tpu.data import sampler as jax_sampler
from recbole_gnn_tpu_torch.data import sampler as torch_sampler

# name: (n_users, n_items, pairs, whether one user has used every item)
SHAPES = {"small": (60, 40, 300, True),
          "wide": (100_000, 100_000, 400, False),
          "tall": (300_000_000, 40, 300, True)}


def _log(name):
    """(users, items, the full user or None, the batch's users)."""
    n_users, n_items, n_pairs, full = SHAPES[name]
    rng = np.random.default_rng(11)
    users = rng.integers(0, n_users, n_pairs)
    items = rng.integers(1, n_items, n_pairs)
    # a few users with many pairs, so that draws collide
    heavy = users[:4]
    hu = np.repeat(heavy, n_items // 2)
    hi = rng.integers(1, n_items, len(hu))
    users, items = np.concatenate([users, hu]), np.concatenate([items, hi])
    full_user = None
    if full:
        full_user = int(users[5])
        users = np.concatenate([users, np.full(n_items - 1, full_user)])
        items = np.concatenate([items, np.arange(1, n_items)])
    batch = np.concatenate([users[:40], heavy, heavy, users[:40]])
    if full_user is not None:
        batch = np.concatenate([batch, [full_user] * 3])
    return users.astype(np.int64), items.astype(np.int64), full_user, batch


@pytest.mark.parametrize("num", [1, 3])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", ["UniformNegativeSampler",
                                  "PopularityNegativeSampler"])
def test_sampler_draws_equal_jax(kind, shape, num):
    n_users, n_items = SHAPES[shape][:2]
    users, items, full_user, batch = _log(shape)
    port = getattr(torch_sampler, kind)(users, items, n_users, n_items)
    ref = getattr(jax_sampler, kind)(users, items, n_users, n_items)
    on_bits = -(-n_users * n_items // 8) <= torch_sampler.BITSET_MAX_BYTES
    assert on_bits == (shape == "small")
    assert (port.used_bits is not None) == on_bits
    assert (port.used_keys is None) == on_bits
    for seed in (0, 2**31 + 5):
        got = port.sample(batch, num, np.random.default_rng(seed))
        want = ref.sample(batch, num, np.random.default_rng(seed))
        assert got.shape == (len(batch), num) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        used = set(zip(users.tolist(), items.tolist()))
        hit = np.array([[(u, i) in used for i in row]
                        for u, row in zip(batch.tolist(), got.tolist())])
        exhausted = batch == full_user
        assert not hit[~exhausted].any()
        assert hit[exhausted].all()
        assert ((got >= 1) & (got < n_items)).all()
