"""The frozen generators write logs of exactly the published shapes."""

from __future__ import annotations

import numpy as np

from portbench.frozen import diginetica_shape, gowalla_shape
from portbench.reference.data import kcore, read_log


def test_gowalla_shape(tmp_path):
    shape = gowalla_shape.GOWALLA_SHAPE
    assert shape == {"n_users": 29858, "n_items": 40981, "n_inter": 1027370}
    path = gowalla_shape.write_gowalla_shape(str(tmp_path), "g", 2020,
                                             **shape)
    t = read_log(path, 2)
    assert len(t) == 1027370
    assert len(np.unique(t[:, 0])) == 29858
    assert len(np.unique(t[:, 1])) == 40981
    assert len(np.unique(t[:, 0] * 40981 + t[:, 1])) == 1027370
    assert np.bincount(t[:, 0]).min() >= 10


def test_diginetica_shape(tmp_path):
    shape = diginetica_shape.DIGINETICA_SHAPE
    assert shape == {"n_sessions": 72014, "n_items": 29454,
                     "n_inter": 580490}
    path = diginetica_shape.write_diginetica_shape(str(tmp_path), "d", 2020,
                                                   **shape)
    t = read_log(path, 3)
    assert len(t) == 580490
    assert len(np.unique(t[:, 0])) == 72014
    assert len(np.unique(t[:, 1])) == 29454
    # the leaderboard's 5-core filter keeps every click
    assert kcore(t[:, 0], t[:, 1], 5, 5).all()
