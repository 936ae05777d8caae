"""Port parity: the general loaders' falsy batch sizes, and full-sort
evaluation under a byte budget.

* ``train_batch_size: 0`` and ``eval_batch_size: 0`` take the defaults
  (2,048 and 4,096) in both packages' loaders, as the JAX package reads
  ``config[k] or default``.
* The port scores a full-sort batch in user chunks of at most
  ``SCORE_BYTES_BUDGET`` bytes of scores and never scores its weight-0
  padding rows; the metrics stay the JAX package's (abs 1e-6: f32 sums
  of the same terms in another order, as ``test_torch_eval.py``).
"""

import jax
import numpy as np
import pytest

import recbole_gnn_tpu_torch.eval.evaluator as t_eval_mod
from conftest import base_config_dict
from recbole_gnn_tpu.config import Config as JConfig
from recbole_gnn_tpu.data.loader import (FullSortEvalLoader as JFull,
                                         NegSampleEvalLoader as JNeg,
                                         TrainLoader as JTrain)
from recbole_gnn_tpu.eval.evaluator import Evaluator as JEvaluator
from recbole_gnn_tpu.models import get_model as j_get_model
from recbole_gnn_tpu.quick_start import create_dataset as j_create_dataset
from recbole_gnn_tpu.quick_start import data_preparation as j_data_preparation
from recbole_gnn_tpu_torch.config import Config as TConfig
from recbole_gnn_tpu_torch.data.loader import (FullSortEvalLoader as TFull,
                                               NegSampleEvalLoader as TNeg,
                                               TrainLoader as TTrain)
from recbole_gnn_tpu_torch.eval.evaluator import Evaluator as TEvaluator
from recbole_gnn_tpu_torch.models import get_model as t_get_model
from recbole_gnn_tpu_torch.quick_start import create_dataset as t_create_dataset
from recbole_gnn_tpu_torch.quick_start import data_preparation as t_data_preparation
from recbole_gnn_tpu_torch.train.checkpoint import params_from_numpy


def _cfg(**over):
    return base_config_dict(**dict(dict(model="LightGCN", embedding_size=16,
                                        n_layers=2, seed=2020,
                                        use_gpu=False), **over))


def _splits(cfg_cls, create, prep, cd):
    c = cfg_cls(config_dict=cd)
    (_, tr), (_, va), _ = prep(c, create(c))
    return c, tr, va


@pytest.mark.parametrize("kind", ["train", "full", "neg"])
def test_falsy_batch_sizes_take_the_defaults(kind):
    cd = _cfg(train_batch_size=0, eval_batch_size=0)
    jc, jtr, jva = _splits(JConfig, j_create_dataset, j_data_preparation, cd)
    tc, ttr, tva = _splits(TConfig, t_create_dataset, t_data_preparation, cd)
    if kind == "train":
        j, t = JTrain(jtr, jc), TTrain(ttr, tc)
        assert j.batch_size == t.batch_size == 2048
    elif kind == "full":
        j, t = JFull(jva, [jtr], jc), TFull(tva, [ttr], tc)
        assert j.batch_size == t.batch_size == 4096
    else:
        j, t = JNeg(jva, [jtr], jc, 10), TNeg(tva, [ttr], tc, 10)
        assert j.batch_size == t.batch_size == 4096
    assert len(j) == len(t) >= 1
    for jb, tb in zip(j, t):
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


@pytest.mark.parametrize("model", ["LightGCN", "NeuMF"])
def test_full_sort_under_a_byte_budget_matches_jax(model, monkeypatch):
    """An ``eval_batch_size`` of 512 users against 1,005 items makes a
    2,058,240-byte score block; under a 40,200-byte budget the port
    scores at most 10 users at a time, only the real ones, and the
    metrics equal the JAX package's unchunked pass."""
    monkeypatch.setattr(t_eval_mod, "SCORE_BYTES_BUDGET", 40_200)
    seen = []
    real_full = TEvaluator._full_sort_sums

    def spy(self, scores, batch):
        seen.append(tuple(scores.shape))
        assert (batch["weight"] > 0).all()
        return real_full(self, scores, batch)

    monkeypatch.setattr(TEvaluator, "_full_sort_sums", spy)
    cd = _cfg(model=model, eval_batch_size=512)
    jc = JConfig(config_dict=cd)
    (_, jtr), (jvl, _), _ = j_data_preparation(jc, j_create_dataset(jc))
    jm = j_get_model(model)(jc, jtr)
    jp = jm.init_params(jax.random.PRNGKey(3))
    want = JEvaluator(jc, jm).evaluate(jp, {}, jvl)
    tc = TConfig(config_dict=cd)
    (_, ttr), (tvl, _), _ = t_data_preparation(tc, t_create_dataset(tc))
    tm = t_get_model(model)(tc, ttr)
    got = TEvaluator(tc, tm).evaluate(
        params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu"), {},
        tvl)
    n_items = tm.n_items
    assert n_items == 1005 and len(tvl) == 1
    assert max(r for r, _ in seen) * n_items * 4 <= 40_200
    assert sum(r for r, _ in seen) == len(tvl.eval_users) < 512
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
