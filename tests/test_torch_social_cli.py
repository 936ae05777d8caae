"""The social family through the port's CLI and serving path on the
CPU.  DiffNet, MHCN and SEPT (past warm-up: ``warm_up_epochs: 0``, so
its subgraph and tri-training run) each train one epoch on the fixture
through ``python -m recbole_gnn_tpu_torch.run --use_gpu=False``
(finite losses and metrics, the test result, a checkpoint), DiffNet on
its sparse ``ell`` matrices, MHCN and SEPT on their dense ones (SEPT's
subgraph on ``ell``).  MHCN's export artifact from one
JAX checkpoint holds the tables of the JAX propagation of that
checkpoint (rtol 1e-5 / atol 1e-6), and ``RecServer`` serves them: its
top-10 equals the plain reference (the tables' product with the
history and PAD masked, ``torch.topk``) exactly."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import base_config_dict
from recbole_gnn_tpu.config import Config as JConfig
from recbole_gnn_tpu.models import get_model as j_get_model
from recbole_gnn_tpu.quick_start import create_dataset as j_create
from recbole_gnn_tpu.quick_start import run_recbole_gnn_tpu as j_run
from recbole_gnn_tpu.train.checkpoint import load_checkpoint as j_load
from recbole_gnn_tpu_torch import serve as t_serve
from recbole_gnn_tpu_torch.config import Config as TConfig
from torch_parity_utils import jax_globals

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {"DiffNet": ["--enable_sparse=True"], "MHCN": [],
          "SEPT": ["--warm_up_epochs=0"]}


@pytest.mark.parametrize("model", list(MODELS))
def test_cli_trains_and_evaluates_on_cpu(tmp_path, model):
    log = tmp_path / "log.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "recbole_gnn_tpu_torch.run", "-m", model,
         "-d", "test",
         f"--data_path={os.path.join(ROOT, 'tests', 'test_data')}",
         "--epochs=1", "--use_gpu=False", "--embedding_size=16",
         f"--checkpoint_dir={tmp_path}", f"--metrics_log_path={log}",
         *MODELS[model]],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    events = [json.loads(line) for line in open(log)]
    losses = [e["loss"] for e in events if e["event"] == "train_epoch"]
    assert len(losses) == 1 and np.isfinite(losses[0])
    valid = [e for e in events if e["event"] == "valid"]
    assert valid and np.isfinite(valid[0]["recall@10"])
    assert "test result" in r.stdout + r.stderr
    assert (tmp_path / f"{model}-test.ckpt").is_file()


def test_mhcn_export_matches_jax_and_serves(tmp_path):
    cd = base_config_dict(model="MHCN", use_gpu=False, embedding_size=16,
                          checkpoint_dir=str(tmp_path))
    with pytest.MonkeyPatch.context() as mp:
        jax_globals(mp)
        j_run(config_dict=cd, saved=True, verbose=False)
        state = j_load(str(tmp_path / "MHCN-test.ckpt"))
        jc = JConfig(config_dict=cd)
        train_ds, _, _ = j_create(jc).build()
        jm = j_get_model("MHCN")(jc, train_ds)
        ju, ji = jm.propagate({k: (jnp.asarray(v) if isinstance(
            v, np.ndarray) else v) for k, v in state["params"].items()},
            jm.consts, {})
    path = t_serve.export_artifact(TConfig(config_dict=cd),
                                   str(tmp_path / "mhcn.npz"), device="cpu")
    with np.load(path, allow_pickle=False) as z:
        np.testing.assert_allclose(z["user_table"], np.asarray(ju),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(z["item_table"], np.asarray(ji),
                                   rtol=1e-5, atol=1e-6)
    srv = t_serve.RecServer(path, device="cpu")
    users = [str(t) for t in srv.user_tokens[1:41]]
    idx, vals = srv.recommend(users, k=10, return_tokens=False)
    uids = srv.resolve_users(users)
    scores = srv.user_table[uids] @ srv.item_table.T
    rows, items = srv._history_pairs(uids)
    scores[rows, items] = float("-inf")
    scores[:, 0] = float("-inf")
    want_vals, want_idx = torch.topk(scores, 10)
    np.testing.assert_array_equal(idx, want_idx.numpy())
    np.testing.assert_array_equal(vals, want_vals.numpy())
