"""A general full sort reads its loader's arrays from the device
(``eval/evaluator.py``, ``FullSortEvalLoader.resident``).

On the CPU:

* The resident path's metrics equal the host path's exactly (the same
  loader's batches handed over as a plain list, which the evaluator
  iterates and copies as before): LightGCN dense and sparse
  (factorized), BPR and NeuMF (``score_users_vs_all``), with a padded
  last batch (37 users a batch), at the default byte budget and at one
  that splits every batch into chunks of 10 users.
* A second pass with the same loader copies nothing: ``h2d_bytes``
  grows by the placement once, ``resident_chunks == chunks`` on both
  passes, and the loader holds one device's arrays.
* uniN/popN, a sequential model and an item-sharded mesh (``tp`` 2 in
  one process) stay on the host path: ``resident_chunks`` 0, a copy
  of every batch every pass, the metrics those of the loader's batches
  as a list.
* ``eval_h2d_mb.train``'s reader: None without counters under
  ``fit/evaluate``, the placement over the validations after a CPU
  ``fit``.

On the card (marked ``cuda``; skipped without one; run there with
``python -m pytest --noconftest tests/test_torch_eval_resident.py``,
since this directory's ``conftest.py`` imports JAX): LightGCN on
``ell``, the resident and host paths equal, and a second pass copies
nothing from the host.

No JAX here: the card's machine has none.
"""

import os

import pytest
import torch

import recbole_gnn_tpu_torch.eval.evaluator as eval_mod
from portbench import harness
from recbole_gnn_tpu_torch.config import Config
from recbole_gnn_tpu_torch.eval.evaluator import Evaluator
from recbole_gnn_tpu_torch.models import get_model
from recbole_gnn_tpu_torch.parallel.mesh import LocalMesh
from recbole_gnn_tpu_torch.quick_start import create_dataset, data_preparation
from recbole_gnn_tpu_torch.train.trainer import Trainer
from recbole_gnn_tpu_torch.utils import trace

TEST_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "test_data")
ELL = {"enable_sparse": True, "sparse_spmm_impl": "ell"}


def _config(tmp_path, model, use_gpu, **over):
    cd = {"model": model, "dataset": "test", "data_path": TEST_DATA,
          "epochs": 1, "state": "ERROR", "train_batch_size": 256,
          "eval_batch_size": 37, "MAX_ITEM_LIST_LENGTH": 20,
          "checkpoint_dir": str(tmp_path), "embedding_size": 16,
          "n_layers": 2, "seed": 7, "topk": [5, 10], "use_gpu": use_gpu}
    cd.update(over)
    return Config(config_dict=cd)


def _setup(cfg, device):
    (train, train_ds), (valid, _), _ = data_preparation(
        cfg, create_dataset(cfg))
    model = get_model(cfg["model"])(cfg, train_ds, device)
    params = model.init_params(torch.Generator().manual_seed(3))
    return model, params, train, valid


def _counters() -> dict:
    agg = trace.snapshot()["unprofiled"].get("evaluate")
    return dict(agg["counters"]) if agg else {}


def _pass(ev, params, loader, mode="full"):
    """(metrics, the pass's counters)."""
    before = _counters()
    got = ev.evaluate(params, {}, loader, mode=mode)
    after = _counters()
    return got, {k: after[k] - before.get(k, 0) for k in after}


# -- CPU -------------------------------------------------------------------

@pytest.mark.parametrize("budget_users", [None, 10])
@pytest.mark.parametrize("model,over", [
    ("LightGCN", {}), ("LightGCN", ELL), ("BPR", {}), ("NeuMF", {})],
    ids=["lightgcn-dense", "lightgcn-ell", "bpr", "neumf"])
def test_resident_metrics_equal_the_host_path(tmp_path, monkeypatch, model,
                                              over, budget_users):
    cfg = _config(tmp_path, model, False, **over)
    m, params, _, valid = _setup(cfg, torch.device("cpu"))
    if budget_users is not None:
        monkeypatch.setattr(eval_mod, "SCORE_BYTES_BUDGET",
                            4 * m.n_items * budget_users)
    n_users = len(valid.eval_users)
    assert n_users % valid.batch_size and len(valid) > 1   # padded last
    ev = Evaluator(cfg, m)
    trace.reset()
    got, c_res = _pass(ev, params, valid)
    want, c_host = _pass(ev, params, list(valid))
    assert got == want and len(got) == 10
    assert c_res["chunks"] == c_res["resident_chunks"] == c_host["chunks"]
    assert c_host["resident_chunks"] == 0
    rows = budget_users or valid.batch_size
    assert c_res["chunks"] == sum(
        -(-min(valid.batch_size, n_users - b0) // rows)
        for b0 in range(0, n_users, valid.batch_size))


@pytest.mark.parametrize("model,over", [("LightGCN", {}), ("NeuMF", {})],
                         ids=["lightgcn", "neumf"])
def test_a_second_pass_copies_nothing(tmp_path, model, over):
    cfg = _config(tmp_path, model, False, **over)
    m, params, _, valid = _setup(cfg, torch.device("cpu"))
    ev = Evaluator(cfg, m)
    trace.reset()
    first, c1 = _pass(ev, params, valid)
    second, c2 = _pass(Evaluator(cfg, m), params, valid)
    indptr, rows, items = valid.history_csr()
    placed = 8 * (valid.eval_users.size + valid.pos_mat.size
                  + valid.pos_cnt.size + rows.size + items.size)
    assert c1["h2d_bytes"] == placed and c2["h2d_bytes"] == 0
    assert c1["passes"] == c2["passes"] == 1
    for c in (c1, c2):
        assert c["resident_chunks"] == c["chunks"] == len(valid)
    assert first == second
    assert list(valid.resident) == [torch.device("cpu")]
    # the CSR holds the padded matrix's real entries, row by row
    assert indptr[-1] == rows.size == valid.hist_cnt.sum()
    for r in (0, len(valid.eval_users) - 1):
        assert items[indptr[r]:indptr[r + 1]].tolist() == \
            valid.hist_mat[r, :valid.hist_cnt[r]].tolist()


@pytest.mark.parametrize("case", ["uni100", "pop50", "sequential", "tp2"])
def test_paths_that_stay_on_the_host(tmp_path, case):
    model = "SRGNN" if case == "sequential" else "LightGCN"
    over = ({"eval_args": {"mode": case}}
            if case in ("uni100", "pop50") else {})
    cfg = _config(tmp_path, model, False, **over)
    m, params, _, valid = _setup(cfg, torch.device("cpu"))
    mode = "candidates" if over else "full"
    mesh = LocalMesh({"dp": 1, "tp": 2}) if case == "tp2" else None
    ev = Evaluator(cfg, m, mesh=mesh)
    assert ev._use_dist_eval(mode) == (case == "tp2")
    batches = list(valid)
    trace.reset()
    got, c1 = _pass(ev, params, valid, mode)
    again, c2 = _pass(ev, params, valid, mode)
    want, _ = _pass(ev, params, batches, mode)
    assert got == again == want and got
    assert not getattr(valid, "resident", None)
    for c in (c1, c2):
        assert c["resident_chunks"] == 0
        assert c["chunks"] == len(batches)   # every user in one chunk
        assert c["h2d_bytes"] > 0
    assert c1["h2d_bytes"] == c2["h2d_bytes"]
    if case == "tp2":   # the item-sharded pass gives the unsharded metrics
        assert got == Evaluator(cfg, m).evaluate(params, {}, valid)


def test_eval_h2d_mb_reader(tmp_path):
    reader = harness.load_module("metrics", "eval_h2d_mb.train")
    trace.reset()
    with trace.span("fit"), trace.span("evaluate"):
        trace.count("chunks", 1)
    assert reader.read(None) is None
    cfg = _config(tmp_path, "LightGCN", False, epochs=2)
    m, _, train, valid = _setup(cfg, torch.device("cpu"))
    trainer = Trainer(cfg, m)
    trace.reset()
    trainer.fit(train, valid, saved=False, verbose=False)
    c = trace.snapshot()["unprofiled"]["fit/evaluate"]["counters"]
    assert c["passes"] == 2 and c["resident_chunks"] == c["chunks"]
    assert reader.read(None) == c["h2d_bytes"] / 2 / 1e6 > 0


# -- the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_resident_path_on_the_card(tmp_path, card):
    cfg = _config(tmp_path, "LightGCN", True, **ELL)
    m, params, _, valid = _setup(cfg, card)
    ev = Evaluator(cfg, m)
    trace.reset()
    got, c1 = _pass(ev, params, valid)
    again, c2 = _pass(ev, params, valid)
    want, c_host = _pass(ev, params, list(valid))
    assert got == again == want and len(got) == 10
    assert c1["h2d_bytes"] > 0 and c2["h2d_bytes"] == 0
    assert c2["resident_chunks"] == c2["chunks"] == len(valid)
    assert c_host["resident_chunks"] == 0 and c_host["h2d_bytes"] > 0
    assert list(valid.resident) == [ev.device] and ev.device.type == "cuda"
