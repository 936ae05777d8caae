"""Port parity: full-sort and uniN/popN evaluation — the metrics, the
chunked top-k, the eval loaders and ``Evaluator.evaluate`` from
JAX-initialised params, on the CPU.

Inputs have no tied scores (random continuous params), so both top-ks
return the same indices; metrics agree to abs 1e-6 (f32 sums of the
same terms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import base_config_dict
from recbole_gnn_tpu.config import Config as JConfig
from recbole_gnn_tpu.eval.evaluator import Evaluator as JEvaluator
from recbole_gnn_tpu.eval.metrics import topk_metrics as j_topk_metrics
from recbole_gnn_tpu.models import get_model as j_get_model
from recbole_gnn_tpu.ops.topk import chunked_full_sort_topk as j_chunked
from recbole_gnn_tpu.quick_start import create_dataset as j_create_dataset
from recbole_gnn_tpu.quick_start import data_preparation as j_data_preparation
from recbole_gnn_tpu_torch.config import Config as TConfig
from recbole_gnn_tpu_torch.eval.evaluator import Evaluator as TEvaluator
from recbole_gnn_tpu_torch.eval.metrics import topk_metrics as t_topk_metrics
from recbole_gnn_tpu_torch.models import get_model as t_get_model
from recbole_gnn_tpu_torch.ops.topk import chunked_full_sort_topk as t_chunked
from recbole_gnn_tpu_torch.quick_start import create_dataset as t_create_dataset
from recbole_gnn_tpu_torch.quick_start import data_preparation as t_data_preparation
from recbole_gnn_tpu_torch.train.checkpoint import params_from_numpy

SPARSE = {"enable_sparse": True, "sparse_spmm_impl": "pallas"}


def _cfg(**over):
    cd = dict(model="LightGCN", embedding_size=16, n_layers=3, seed=2020,
              use_gpu=False, eval_batch_size=37, topk=[5, 10])
    return base_config_dict(**dict(cd, **over))


# -- metrics and top-k ------------------------------------------------------

def test_topk_metrics_match_jax_on_random_inputs():
    rng = np.random.default_rng(17)
    b, n_items, k, p = 64, 200, 10, 12
    topk = np.stack([rng.permutation(np.arange(1, n_items))[:k]
                     for _ in range(b)])                    # no repeats
    pos_len = rng.integers(0, p + 1, b)
    pos = np.zeros((b, p), np.int64)
    for r in range(b):
        # half of each row's positives from its top-k, half outside it
        pool = np.concatenate([topk[r][:p // 2],
                               rng.integers(1, n_items, p)])
        pos[r, :pos_len[r]] = rng.permutation(np.unique(pool))[:pos_len[r]]
        pos_len[r] = min(pos_len[r], len(np.unique(pool)))
    want = j_topk_metrics(jnp.asarray(topk), jnp.asarray(pos),
                          jnp.asarray(pos_len), (1, 5, 10))
    got = t_topk_metrics(torch.from_numpy(topk), torch.from_numpy(pos),
                         torch.from_numpy(pos_len), (1, 5, 10))
    assert got.keys() == want.keys() and len(got) == 15
    for key in want:
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    assert float(got["hit@10"].sum()) > 0


def test_topk_metrics_hand_computed():
    topk = torch.tensor([[3, 9, 7, 2, 5], [1, 2, 6, 8, 4]])
    pos = torch.tensor([[3, 7, 0], [4, 0, 0]])
    m = {k: v.numpy() for k, v in
         t_topk_metrics(topk, pos, torch.tensor([2, 1]), (5,)).items()}
    dcg0, idcg0 = 1.0 + 1.0 / np.log2(4), 1.0 + 1.0 / np.log2(3)
    np.testing.assert_allclose(m["recall@5"], [1.0, 1.0], rtol=1e-6)
    np.testing.assert_allclose(m["precision@5"], [0.4, 0.2], rtol=1e-6)
    np.testing.assert_allclose(m["mrr@5"], [1.0, 0.2], rtol=1e-6)
    np.testing.assert_allclose(m["ndcg@5"], [dcg0 / idcg0, 1.0 / np.log2(6)],
                               rtol=1e-6)


@pytest.mark.parametrize("chunk", [8, 1024])
def test_chunked_full_sort_topk_matches_jax(chunk):
    rng = np.random.default_rng(23)
    ue = rng.normal(size=(29, 8)).astype(np.float32)
    ie = rng.normal(size=(150, 8)).astype(np.float32)
    hist = rng.random((29, 150)) < 0.2
    jv, ji = j_chunked(jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(hist),
                       k=5, chunk=chunk)
    tv, ti = t_chunked(torch.from_numpy(ue), torch.from_numpy(ie),
                       torch.from_numpy(hist), k=5, chunk=chunk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    assert t_chunked(torch.from_numpy(ue[:0]), torch.from_numpy(ie),
                     torch.from_numpy(hist[:0]), k=5)[1].shape == (0, 5)


# -- eval loaders -------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "uni100", "pop50"])
def test_eval_loader_batches_equal_jax(mode):
    cd = _cfg(eval_args={"mode": mode})
    out = []
    for cfg_cls, create, prep in ((JConfig, j_create_dataset,
                                   j_data_preparation),
                                  (TConfig, t_create_dataset,
                                   t_data_preparation)):
        c = cfg_cls(config_dict=cd)
        _, (vl, _), (te, _) = prep(c, create(c))
        out.append([list(vl), list(te)])
    for jb_list, tb_list in zip(*out):
        assert len(jb_list) == len(tb_list) > 1
        assert (tb_list[-1]["weight"] == 0).any()     # padded last batch
        for a, b in zip(jb_list, tb_list):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)


# -- Evaluator.evaluate ------------------------------------------------------

EVAL_CASES = [("LightGCN", {}, "full"), ("LightGCN", {}, "uni100"),
              ("LightGCN", SPARSE, "full"), ("BPR", {}, "full"),
              ("BPR", {}, "pop50")]


@pytest.mark.parametrize("model,over,mode", EVAL_CASES,
                         ids=["lgcn-full", "lgcn-uni100", "lgcn-sparse-full",
                              "bpr-full", "bpr-pop50"])
def test_evaluate_matches_jax(monkeypatch, model, over, mode):
    import importlib
    j_spmm_mod = importlib.import_module("recbole_gnn_tpu.ops.spmm")
    monkeypatch.setattr(j_spmm_mod, "SPMM_IMPL", j_spmm_mod.SPMM_IMPL)
    cd = _cfg(model=model, eval_args={"mode": mode}, **over)
    jc, tc = JConfig(config_dict=cd), TConfig(config_dict=cd)
    (_, jtr), (jvl, _), _ = j_data_preparation(jc, j_create_dataset(jc))
    (_, ttr), (tvl, _), _ = t_data_preparation(tc, t_create_dataset(tc))
    jm, tm = j_get_model(model)(jc, jtr), t_get_model(model)(tc, ttr)
    jp = jm.init_params(jax.random.PRNGKey(7))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    emode = "full" if mode == "full" else "candidates"
    want = JEvaluator(jc, jm).evaluate(jp, {}, jvl, mode=emode)
    got = TEvaluator(tc, tm).evaluate(tp, {}, tvl, mode=emode)
    assert got.keys() == want.keys() and len(got) == 10
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    # eval_scan (a TPU dispatch knob) runs the same loop, same numbers
    tc["eval_scan"] = True
    assert TEvaluator(tc, tm).evaluate(tp, {}, tvl, mode=emode) == got


def test_padded_eval_rows_do_not_shift_averages():
    tm = tp = None
    results = []
    for bs in (37, 512):
        c = TConfig(config_dict=_cfg(model="BPR", eval_batch_size=bs))
        (_, tr), (vl, _), _ = t_data_preparation(c, t_create_dataset(c))
        if tm is None:
            tm = t_get_model("BPR")(c, tr)
            tp = tm.init_params(torch.Generator().manual_seed(0))
        results.append(TEvaluator(c, tm).evaluate(tp, {}, vl))
    for k in results[0]:
        np.testing.assert_allclose(results[0][k], results[1][k], rtol=1e-5,
                                   atol=1e-7)


def test_sequential_and_mesh_evaluation_raise():
    """Ported since (``parallel/``): ``Evaluator(mesh=)``.  Over a mesh
    of one (no process group) LightGCN's full sort runs item-sharded
    exactly when the mesh has ``tp`` > 1, as the JAX ``Evaluator``
    decides from the mode and ``tp`` alone, and gives the single-device
    metrics; a sequential model over a mesh evaluates as without one
    (the JAX evaluator's sequential path reads no mesh).  Across ranks:
    ``test_torch_parallel_ranks.py``."""
    from recbole_gnn_tpu_torch.parallel.mesh import make_mesh
    c = TConfig(config_dict=_cfg())
    (_, tr), (vl, _), _ = t_data_preparation(c, t_create_dataset(c))
    m = t_get_model("LightGCN")(c, tr)
    p = m.init_params(torch.Generator().manual_seed(0))
    want = TEvaluator(c, m).evaluate(p, {}, vl)
    ev = TEvaluator(c, m, mesh=make_mesh({"dp": 1, "tp": 1}))
    assert not ev._use_dist_eval("full")
    assert ev.evaluate(p, {}, vl) == want

    sc = TConfig(config_dict=_cfg(model="SRGNN"))
    (_, str_), (svl, _), _ = t_data_preparation(sc, t_create_dataset(sc))
    seq = t_get_model("SRGNN")(sc, str_)
    sp = seq.init_params(torch.Generator().manual_seed(0))
    sev = TEvaluator(sc, seq, mesh=make_mesh([1]))
    assert sev.is_sequential and sev.mesh is not None
    assert sev.evaluate(sp, {}, svl) == TEvaluator(sc, seq).evaluate(
        sp, {}, svl)
