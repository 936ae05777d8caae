"""Port parity: the session data path.

Every sequential dataset class of the port (``SequentialDataset``,
``SessionGraphDataset``, ``GCEGNNDataset``, ``LESSRDataset``,
``MultiBehaviorDataset``) gives the JAX package's arrays element for
element on the fixture, split by split, with the session graphs built
by the port's C++ builder and by its numpy path; the native builder and
k-core filter (built from the port's own copy of the source) equal the
numpy paths on random data; and the sequential loaders give the JAX
package's batches (train with and without BPR negatives, full sort,
uni100 and pop100).
"""

import os

import numpy as np
import pytest

from recbole_gnn_tpu.config import Config as JConfig
from recbole_gnn_tpu.data import session as j_session
from recbole_gnn_tpu.quick_start import create_dataset as j_create_dataset
from recbole_gnn_tpu.quick_start import data_preparation as j_data_preparation
from recbole_gnn_tpu_torch import native
from recbole_gnn_tpu_torch.config import Config as TConfig
from recbole_gnn_tpu_torch.data import session as t_session
from recbole_gnn_tpu_torch.data.dataset import Dataset as TDataset
from recbole_gnn_tpu_torch.quick_start import create_dataset as t_create_dataset
from recbole_gnn_tpu_torch.quick_start import data_preparation as t_data_preparation
from torch_parity_utils import seq_cfg

DATASETS = {"SRGNN": "SessionGraphDataset", "SASRec": "SequentialDataset",
            "GCEGNN": "GCEGNNDataset", "LESSR": "LESSRDataset"}


def numpy_path(mp):
    """Send the port down its numpy paths (no C++ library)."""
    mp.setattr(native, "build_session_graphs_native", lambda *a, **k: None)
    mp.setattr(native, "kcore_filter_native", lambda *a, **k: None)


def splits(cd, pkg):
    cfg_cls, create, prep = ((JConfig, j_create_dataset, j_data_preparation)
                             if pkg == "jax" else
                             (TConfig, t_create_dataset, t_data_preparation))
    c = cfg_cls(config_dict=cd)
    (tl, tr), (vl, va), (te, ts) = prep(c, create(c))
    return (tl, vl, te), (tr, va, ts)


def assert_split_equal(t_ds, j_ds):
    assert type(t_ds).__name__ == type(j_ds).__name__
    assert sorted(t_ds.inter) == sorted(j_ds.inter)
    for k in j_ds.inter:
        np.testing.assert_array_equal(t_ds.inter[k], j_ds.inter[k], err_msg=k)
    tg = getattr(t_ds, "session_graphs", None)
    jg = getattr(j_ds, "session_graphs", None)
    assert (tg is None) == (jg is None)
    if jg is not None:
        assert sorted(tg) == sorted(jg)
        for k in jg:
            assert tg[k].dtype == jg[k].dtype, k
            np.testing.assert_array_equal(tg[k], jg[k], err_msg=k)
    for attr in ("max_local_edges", "max_shortcut_edges", "max_seq_len",
                 "n_items", "n_users", "behavior_names"):
        assert getattr(t_ds, attr, None) == getattr(j_ds, attr, None), attr
    np.testing.assert_array_equal(
        t_ds.field2id_token[t_ds.iid_field],
        j_ds.field2id_token[j_ds.iid_field])


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("model", list(DATASETS))
def test_dataset_arrays_equal_jax(monkeypatch, model, path):
    if path == "numpy":
        numpy_path(monkeypatch)
    cd = seq_cfg(model)
    (_, j_splits), (_, t_splits) = splits(cd, "jax"), splits(cd, "torch")
    assert type(t_splits[0]).__name__ == DATASETS[model]
    for t_ds, j_ds in zip(t_splits, j_splits):
        assert_split_equal(t_ds, j_ds)


def test_multibehavior_dataset_equals_jax():
    cd = seq_cfg("SRGNN")
    t_ds = t_session.MultiBehaviorDataset(TConfig(config_dict=cd))
    j_ds = j_session.MultiBehaviorDataset(JConfig(config_dict=cd))
    for t_s, j_s in zip(t_ds.build(), j_ds.build()):
        assert "x__interaction" in t_s.session_graphs
        assert_split_equal(t_s, j_s)


def random_sessions(rng, n, L, n_items):
    lengths = rng.integers(0, L + 1, size=n).astype(np.int32)
    seqs = rng.integers(1, n_items, size=(n, L)).astype(np.int32)
    # revisits: about a third of positions repeat an earlier item
    rep = rng.random((n, L)) < 0.3
    back = np.maximum(np.arange(L)[None, :] - rng.integers(1, 4, (n, L)), 0)
    seqs = np.where(rep, np.take_along_axis(seqs, back, axis=1), seqs)
    seqs[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return seqs, lengths


@pytest.mark.parametrize("n,L,n_items", [(1, 1, 3), (37, 5, 4),
                                         (5000, 20, 50), (9000, 12, 9000)])
def test_native_builder_equals_numpy_and_jax(monkeypatch, n, L, n_items):
    assert native.native_available()
    # built from the port's own source into the port's build directory
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(native.BUILD_DIR)) == \
        "recbole_gnn_tpu_torch"
    assert os.path.isfile(native.SOURCE)
    seqs, lengths = random_sessions(np.random.default_rng(n + L), n, L,
                                    n_items)
    got = t_session.build_session_graphs(seqs, lengths, L)
    numpy_path(monkeypatch)
    plain = t_session.build_session_graphs(seqs, lengths, L)
    x, n_nodes = j_session._unique_per_row(seqs)
    alias = j_session._alias_per_row(x, n_nodes, seqs, lengths)
    src, dst, n_edges = j_session.SessionGraphDataset._consecutive_edges(
        alias, lengths, L)
    want = {"x": x, "n_nodes": n_nodes, "alias_inputs": alias,
            "edge_src": src, "edge_dst": dst, "n_edges": n_edges}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=f"native {k}")
        np.testing.assert_array_equal(plain[k], v, err_msg=f"numpy {k}")


def test_native_kcore_equals_numpy_loop(monkeypatch):
    rng = np.random.default_rng(5)
    users = rng.zipf(1.6, 20000) % 900
    items = rng.zipf(1.4, 20000) % 700
    for lo_u, lo_i in ((5, 5), (3, 10), (0, 2)):
        keep = native.kcore_filter_native(users, items, 900, 700, lo_u,
                                          np.iinfo(np.int64).max, lo_i,
                                          np.iinfo(np.int64).max)
        alive = np.ones(len(users), bool)
        while True:
            uc = np.bincount(users[alive], minlength=900)
            ic = np.bincount(items[alive], minlength=700)
            ok = alive & (uc[users] >= lo_u) & (ic[items] >= lo_i)
            if (ok == alive).all():
                break
            alive = ok
        np.testing.assert_array_equal(keep, alive)
        assert 0 < keep.sum() < len(users)


@pytest.mark.parametrize("spec", [("[5,inf)", "[5,inf)"), ("(11,25]", None),
                                  (None, "[8,inf)")])
def test_dataset_kcore_native_equals_numpy_and_jax(monkeypatch, spec):
    cd = seq_cfg("SRGNN", user_inter_num_interval=spec[0],
                 item_inter_num_interval=spec[1])
    native_ds = TDataset(TConfig(config_dict=cd))
    j_ds = j_session.SessionGraphDataset(JConfig(config_dict=cd))
    numpy_path(monkeypatch)
    numpy_ds = TDataset(TConfig(config_dict=cd))
    assert 0 < native_ds.inter_num < 6000
    for k in j_ds.inter:
        np.testing.assert_array_equal(native_ds.inter[k], numpy_ds.inter[k])
        np.testing.assert_array_equal(native_ds.inter[k], j_ds.inter[k])


LOADER_CASES = {
    "full": {},
    "bpr": {"loss_type": "BPR",
            "train_neg_sample_args": {"distribution": "uniform",
                                      "sample_num": 1}},
    "uni100": {"eval_args": {"split": {"LS": "valid_and_test"},
                             "mode": "uni100", "order": "TO"}},
    "pop100": {"eval_args": {"split": {"LS": "valid_and_test"},
                             "mode": "pop100", "order": "TO"}}}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_sequential_loader_batches_equal_jax(case):
    cd = seq_cfg("SRGNN", **LOADER_CASES[case])
    (j_loaders, _), (t_loaders, _) = splits(cd, "jax"), splits(cd, "torch")
    for epoch in range(2):
        for j_l, t_l in zip(j_loaders, t_loaders):
            assert type(t_l).__name__ == type(j_l).__name__
            assert len(t_l) == len(j_l)
            jb, tb = list(j_l), list(t_l)
            assert len(jb) == len(tb) and jb
            for a, b in zip(jb, tb):
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    train = list(t_loaders[0])
    if case == "bpr":
        assert "neg_item_id" in train[0]
    assert (train[-1]["weight"] == 0).any()
