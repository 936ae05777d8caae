"""Port parity: atomic loading, filters, remap, splits and the
normalised graph of recbole_gnn_tpu_torch against the JAX package, on
the fixture dataset."""

import numpy as np
import pytest
import torch

from conftest import base_config_dict
from recbole_gnn_tpu.config import Config as JConfig
from recbole_gnn_tpu.data.dataset import GeneralGraphDataset as JDataset
from recbole_gnn_tpu_torch.config import Config as TConfig
from recbole_gnn_tpu_torch.data.dataset import GeneralGraphDataset as TDataset
from recbole_gnn_tpu_torch.ops.spmm import BipartiteDenseGraph, Graph


def _pair(**over):
    cd = base_config_dict(model="LightGCN", **over)
    return (TDataset(TConfig(config_dict=cd)),
            JDataset(JConfig(config_dict=cd)))


def _assert_inter_equal(t, j):
    assert t.inter.keys() == j.inter.keys()
    for k in j.inter:
        np.testing.assert_array_equal(t.inter[k], j.inter[k], err_msg=k)


@pytest.fixture(scope="module")
def fixture_pair():
    return _pair()


def test_remap_and_vocab_equal(fixture_pair):
    t, j = fixture_pair
    _assert_inter_equal(t, j)
    assert t.field2type == j.field2type
    for f in (j.uid_field, j.iid_field):
        np.testing.assert_array_equal(t.field2id_token[f], j.field2id_token[f])
        assert t.field2token_id[f] == j.field2token_id[f]
    assert (t.n_users, t.n_items, t.inter_num) == (j.n_users, j.n_items,
                                                  j.inter_num)
    assert t.inter[t.uid_field].dtype == np.int32


@pytest.mark.parametrize("eval_args", [
    {"split": {"RS": [0.8, 0.1, 0.1]}, "group_by": "user", "order": "RO"},
    {"split": {"RS": [0.7, 0.2, 0.1]}, "group_by": "none", "order": "RO"},
    {"split": {"RS": [0.8, 0.1, 0.1]}, "group_by": "user", "order": "TO"},
    {"split": {"LS": "valid_and_test"}, "group_by": "user", "order": "TO"},
])
def test_splits_equal(eval_args):
    t, j = _pair(eval_args=eval_args, seed=7)
    for ts, js in zip(t.build(), j.build()):
        _assert_inter_equal(ts, js)
        a, b = ts.user_item_arrays(), js.user_item_arrays()
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("over", [
    {"user_inter_num_interval": "[20,inf)",
     "item_inter_num_interval": "[8,inf)"},
    {"user_inter_num_interval": "(10,60]"},
    {"val_interval": {"rating": "[3,inf)"},
     "item_inter_num_interval": "[5,inf)"},
])
def test_value_and_kcore_filters_equal(over):
    """The port's numpy k-core loop against the JAX package, which
    takes its C++ fixed-point filter where it is built."""
    t, j = _pair(**over)
    assert t.inter_num < 6000
    _assert_inter_equal(t, j)
    np.testing.assert_array_equal(t.field2id_token[t.iid_field],
                                  j.field2id_token[j.iid_field])


def test_norm_adj_dense_equal(fixture_pair):
    t, j = fixture_pair
    gt = t.get_norm_adj_graph(device="cpu")
    gj = j.get_norm_adj_graph()
    assert isinstance(gt, BipartiteDenseGraph)
    assert (gt.n_users, gt.n_items, gt.nnz) == (gj.n_users, gj.n_items, gj.nnz)
    np.testing.assert_array_equal(gt.a.numpy(), np.asarray(gj.a))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_norm_adj_sparse_equal(use_pallas):
    t, j = _pair(enable_sparse=True, use_pallas_spmm=use_pallas,
                 sparse_spmm_impl="pallas")
    gt = t.get_norm_adj_graph(device="cpu")
    gj = j.get_norm_adj_graph()
    assert isinstance(gt, Graph)
    assert (gt.n_nodes, gt.n_src_nodes, gt.nnz) == (gj.n_nodes,
                                                   gj.n_src_nodes, gj.nnz)
    assert gt.impl == "pallas" and gt.precision == "f32x2"
    for name in ("src", "dst", "weight", "rev_src", "rev_dst",
                 "rev_edge_id", "rev_weight"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                      np.asarray(getattr(gj, name)),
                                      err_msg=name)
    if use_pallas:      # padded to the TPU segment layout
        assert gt.n_edges_padded > gt.nnz
        assert gt.n_edges_padded == gj.n_edges_padded
    dst = gt.dst.numpy()
    np.testing.assert_array_equal(
        gt.rowptr.numpy(), np.searchsorted(dst, np.arange(gt.n_nodes + 1)))
    np.testing.assert_array_equal(
        gt.rev_rowptr.numpy(),
        np.searchsorted(gt.rev_dst.numpy(), np.arange(gt.n_src_nodes + 1)))
    assert gt.rowptr.dtype == torch.int64 and gt.src.dtype == torch.int32


def test_force_sparse_and_dense_budget():
    t, _ = _pair(dense_graph_max_entries=10)
    assert isinstance(t.get_norm_adj_graph(device="cpu"), Graph)
    t, _ = _pair()
    assert isinstance(t.get_norm_adj_graph(device="cpu", force_sparse=True),
                      Graph)


def test_graph_dtype_bfloat16():
    t, _ = _pair(graph_dtype="bfloat16")
    assert t.get_norm_adj_graph(device="cpu").a.dtype == torch.bfloat16


def test_edge_sharding_not_ported():
    t, _ = _pair(enable_sparse=True, graph_edge_sharding=True,
                 mesh_shape=[2])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t.get_norm_adj_graph(device="cpu")
