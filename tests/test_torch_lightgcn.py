"""Port parity: LightGCN propagation and checkpoints.

Params are drawn by the JAX package's init, saved/loaded as numpy and
carried onto the port with ``params_from_numpy``; both packages then
propagate over the same fixture graph.  Tolerance rtol 1e-5 / atol
1e-6: the same f32 sums, taken in another order.
"""

import jax
import numpy as np
import pytest
import torch

from conftest import base_config_dict
from recbole_gnn_tpu.config import Config as JConfig
from recbole_gnn_tpu.data.dataset import GeneralGraphDataset as JDataset
from recbole_gnn_tpu.models.general.lightgcn import LightGCN as JLightGCN
from recbole_gnn_tpu.train.checkpoint import load_checkpoint as j_load
from recbole_gnn_tpu.train.checkpoint import save_checkpoint as j_save
from recbole_gnn_tpu_torch.config import Config as TConfig
from recbole_gnn_tpu_torch.data.dataset import GeneralGraphDataset as TDataset
from recbole_gnn_tpu_torch.models.general.lightgcn import LightGCN as TLightGCN
from recbole_gnn_tpu_torch.models.init import xavier_uniform
from recbole_gnn_tpu_torch.ops.spmm import BipartiteDenseGraph, Graph
from recbole_gnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   params_from_numpy,
                                                   save_checkpoint)
from recbole_gnn_tpu_torch.utils.seed import init_seed


def _models(**over):
    cd = base_config_dict(model="LightGCN", embedding_size=16, n_layers=3,
                          use_gpu=False, **over)
    tc, jc = TConfig(config_dict=cd), JConfig(config_dict=cd)
    t_train = TDataset(tc).build()[0]
    j_train = JDataset(jc).build()[0]
    return TLightGCN(tc, t_train), JLightGCN(jc, j_train)


@pytest.mark.parametrize("over,graph_cls", [
    ({}, BipartiteDenseGraph),
    ({"enable_sparse": True, "sparse_spmm_impl": "pallas"}, Graph),
    ({"enable_sparse": True, "use_pallas_spmm": False}, Graph),
])
def test_propagate_matches_jax(over, graph_cls):
    tm, jm = _models(**over)
    assert isinstance(tm.consts["graph"], graph_cls)
    assert tm.device == torch.device("cpu")
    jp = jm.init_params(jax.random.PRNGKey(3))
    np_params = {k: np.asarray(v) for k, v in jp.items()}
    tp = params_from_numpy(np_params, "cpu")
    ju, ji = jm.propagate(jp, jm.consts, {})
    tu, ti = tm.propagate(tp, tm.consts, {})
    assert tu.shape == (tm.n_users, 16) and ti.shape == (tm.n_items, 16)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-6)


def test_init_params_seeded_and_in_range():
    tm, _ = _models()
    a = tm.init_params(init_seed(5))
    b = tm.init_params(init_seed(5))
    c = tm.init_params(init_seed(6))
    for k in ("user_emb", "item_emb"):
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    limit = np.sqrt(6.0 / (tm.n_users + 16))
    assert a["user_emb"].shape == (tm.n_users, 16)
    assert float(a["user_emb"].abs().max()) <= limit
    assert a["user_emb"].dtype == torch.float32


def test_xavier_uniform_same_draws_on_any_target_device():
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    assert torch.equal(xavier_uniform(g1, (7, 3)),
                       xavier_uniform(g2, (7, 3), device="cpu"))


def test_checkpoints_cross_load(tmp_path):
    """The port reads what the JAX package writes and vice versa."""
    rng = np.random.default_rng(0)
    state = {"params": {"user_emb": rng.normal(size=(5, 4)).astype(np.float32),
                        "item_emb": rng.normal(size=(7, 4)).astype(np.float32)},
             "opt_state": {"m": [rng.normal(size=3)], "step": np.int64(4)},
             "extras": {}, "epoch": np.int64(2),
             "best_score": np.float64(np.nan),
             "config": {"model": "LightGCN", "dataset": "test"}}
    j_save(str(tmp_path / "j.ckpt"), state)
    t_state = dict(state, params=params_from_numpy(state["params"], "cpu"))
    save_checkpoint(str(tmp_path / "t.ckpt"), t_state)
    for got in (load_checkpoint(str(tmp_path / "j.ckpt")),
                j_load(str(tmp_path / "t.ckpt"))):
        assert got["config"] == state["config"]
        assert int(got["epoch"]) == 2 and np.isnan(got["best_score"])
        assert isinstance(got["opt_state"]["m"], list)
        np.testing.assert_array_equal(got["opt_state"]["m"][0],
                                      state["opt_state"]["m"][0])
        for k in ("user_emb", "item_emb"):
            np.testing.assert_array_equal(np.asarray(got["params"][k]),
                                          state["params"][k])
    carried = params_from_numpy(load_checkpoint(str(tmp_path / "j.ckpt"))
                                ["params"], "cpu")
    assert carried["user_emb"].dtype == torch.float32
    assert torch.equal(carried["user_emb"],
                       torch.from_numpy(state["params"]["user_emb"]))


def test_model_without_use_gpu_false_needs_cuda():
    cd = base_config_dict(model="LightGCN")
    tc = TConfig(config_dict=cd)
    train = TDataset(tc).build()[0]
    if torch.cuda.is_available():
        assert TLightGCN(tc, train).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--use_gpu=False"):
            TLightGCN(tc, train)
    assert TLightGCN(tc, train, device="cpu").device.type == "cpu"
