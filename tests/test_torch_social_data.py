"""Port parity: ``SocialDataset`` and the social family's host matrices.

On the fixture's ``test.net`` every array equals the JAX package's
element for element: the net after the undirected duplication and the
filter by interactions, the joint user vocabulary, the normalised net
graph's edges and weights (sym and row), ``net_coo``, ``inter_coo``,
``num`` and, from ``.user``/``.item`` review columns, ``feat_matrix``;
MHCN's H_s, H_j, H_p and R and SEPT's friend and sharing views equal
the JAX ones as scipy matrices (the JAX package keeps them only on the
device: dense at the fixture's size, so they are compared there).
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp

from conftest import TEST_DATA, base_config_dict
from recbole_gnn_tpu.config import Config as JConfig
from recbole_gnn_tpu.models import get_model as j_get_model
from recbole_gnn_tpu.quick_start import create_dataset as j_create
from recbole_gnn_tpu.quick_start import data_preparation as j_prep
from recbole_gnn_tpu_torch.config import Config as TConfig
from recbole_gnn_tpu_torch.models.social.mhcn import (interaction_matrix,
                                                      motif_matrices)
from recbole_gnn_tpu_torch.models.social.sept import user_views
from recbole_gnn_tpu_torch.quick_start import create_dataset as t_create
from recbole_gnn_tpu_torch.quick_start import data_preparation as t_prep
from torch_parity_utils import jax_globals, review_data


def datasets(cd):
    return (j_create(JConfig(config_dict=cd)),
            t_create(TConfig(config_dict=cd)))


def test_social_dataset_arrays_match_jax(monkeypatch):
    jax_globals(monkeypatch)
    cd = base_config_dict(model="MHCN", use_gpu=False)
    jd, td = datasets(cd)
    assert type(td).__name__ == "SocialDataset"
    raw = len(open(os.path.join(TEST_DATA, "test", "test.net")).read()
              .splitlines()) - 1
    # undirected duplication, then the filter by interactions
    assert td.net_num == jd.net_num and raw < td.net_num <= 2 * raw
    for k in jd.net:
        np.testing.assert_array_equal(td.net[k], jd.net[k], err_msg=k)
    for f in ("user_id", "item_id"):
        assert list(td.field2id_token[f]) == list(jd.field2id_token[f])
        assert td.num(f) == jd.num(f)
    with pytest.raises(KeyError):
        td.num("no_such_field")
    for got, want in ((td.net_coo(), jd.net_coo()),
                      (td.inter_coo(), jd.inter_coo()),
                      (td.net_edges(), jd.net_edges())):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for row_norm in (False, True):
        tg = td.get_norm_net_adj_graph(row_norm, device="cpu")
        jg = jd.get_norm_net_adj_graph(row_norm)
        for k in ("src", "dst", "weight"):
            np.testing.assert_array_equal(getattr(tg, k).numpy(),
                                          np.asarray(getattr(jg, k)))
        assert tg.nnz == jg.nnz and tg.impl == "ell"
        assert tg.ell is not None and tg.rev_ell is not None


def test_social_filter_keeps_net_users_that_interact(monkeypatch):
    """Without the filter, net users with no interaction join the
    vocabulary; with it, no net edge touches one (both packages)."""
    jax_globals(monkeypatch)
    cd = base_config_dict(model="DiffNet", use_gpu=False,
                          filter_net_by_inter=False, undirected_net=False)
    jd, td = datasets(cd)
    assert td.net_num == jd.net_num
    assert list(td.field2id_token["user_id"]) == \
        list(jd.field2id_token["user_id"])
    for k in jd.net:
        np.testing.assert_array_equal(td.net[k], jd.net[k])


def test_feat_matrix_matches_jax(monkeypatch, tmp_path):
    jax_globals(monkeypatch)
    cd = base_config_dict(model="DiffNet", use_gpu=False,
                          **review_data(tmp_path))
    jd, td = datasets(cd)
    for table, field in (("user_feat", "user_review_emb"),
                         ("item_feat", "item_review_emb")):
        got = td.feat_matrix(table, field)
        want = jd.feat_matrix(table, field)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype and got.shape[1] == 8
        assert (np.abs(got).sum(1) == 0).sum() > 1   # rows without one
    ids = td.feat_matrix("user_feat", "user_id")     # a plain column
    np.testing.assert_array_equal(ids, jd.feat_matrix("user_feat",
                                                      "user_id"))


@pytest.fixture(scope="module")
def trained_splits():
    with pytest.MonkeyPatch.context() as mp:
        jax_globals(mp)
        out = {}
        for name in ("MHCN", "SEPT"):
            cd = base_config_dict(model=name, use_gpu=False)
            jc = JConfig(config_dict=cd)
            (_, jtr), _, _ = j_prep(jc, j_create(jc))
            tc = TConfig(config_dict=cd)
            (_, ttr), _, _ = t_prep(tc, t_create(tc))
            out[name] = (j_get_model(name)(jc, jtr), ttr)
        return out


def dense_equal(m, want):
    assert sp.issparse(m)
    np.testing.assert_array_equal(np.asarray(m.todense(), np.float32),
                                  np.asarray(want))


def test_mhcn_motif_matrices_match_jax(trained_splits):
    jm, ttr = trained_splits["MHCN"]
    h = motif_matrices(ttr)
    for name, m in zip(("H_s", "H_j", "H_p"), h):
        dense_equal(m, jm.consts[name])
        assert m.nnz > 0, name                     # no empty channel
    r = interaction_matrix(ttr)
    dense_equal(r, jm.consts["R_ui"])
    dense_equal(r.T.tocsr(), jm.consts["R_iu"])


def test_sept_views_match_jax(trained_splits):
    jm, ttr = trained_splits["SEPT"]
    friend, sharing = user_views(ttr)
    dense_equal(friend, jm.consts["friend"])
    dense_equal(sharing, jm.consts["sharing"])
    assert friend.nnz > ttr.n_users and sharing.nnz > ttr.n_users
