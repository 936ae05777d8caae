"""The eight general models the port adds (NGCF, SGL, NCL, HMLET,
LightGCL, DirectAU, NeuMF, SSL4REC) train and evaluate on the fixture
through the port's CLI on the CPU (``--use_gpu=False``): one epoch,
finite test metrics and a checkpoint.  NCL runs with ``warm_up_step:
0`` and HMLET with ``warm_up_epochs: -1`` (its gates train from epoch
warm_up_epochs + 1), so ProtoNCE and the gates' training are on the
path; SGL, LightGCL and DirectAU (LightGCN encoder) on the sparse
``ell`` graph, NGCF with edge dropout."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODELS = {"NGCF": ["--node_dropout=0.1"],
          "SGL": ["--enable_sparse=True"],
          "NCL": ["--num_clusters=10", "--warm_up_step=0"],
          "HMLET": ["--warm_up_epochs=-1"],
          "LightGCL": ["--enable_sparse=True"],
          "DirectAU": ["--encoder=LightGCN", "--enable_sparse=True"],
          "NeuMF": [],
          "SSL4REC": []}


@pytest.mark.parametrize("model", list(MODELS))
def test_cli_trains_and_evaluates_on_cpu(tmp_path, model):
    log = tmp_path / "log.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "recbole_gnn_tpu_torch.run", "-m", model,
         "-d", "test", f"--data_path={os.path.join(ROOT, 'tests', 'test_data')}",
         "--epochs=1", "--state=ERROR", "--use_gpu=False",
         "--embedding_size=16", f"--checkpoint_dir={tmp_path}",
         f"--metrics_log_path={log}", *MODELS[model]],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    events = [json.loads(line) for line in open(log)]
    losses = [e["loss"] for e in events if e["event"] == "train_epoch"]
    assert len(losses) == 1 and np.isfinite(losses[0])
    valid = [e for e in events if e["event"] == "valid"]
    assert valid and np.isfinite(valid[0]["recall@10"])
    assert (tmp_path / f"{model}-test.ckpt").is_file()
