"""The five session-graph models the port adds (SRGNN, NISER, TAGNN,
GCSAN, SGNNHN) train and evaluate on the fixture through the port's
CLI on the CPU (``--use_gpu=False``): one epoch, finite losses and
metrics, the test result and a checkpoint.  Without ``--use_gpu=False``
and with no card the run stops with the port's ``RuntimeError``.  (The
sequence models: ``test_torch_session_cli_seq.py``.)"""

import pytest
import torch

from torch_parity_utils import check_session_cli, session_cli

MODELS = {"SRGNN": [], "NISER": [], "TAGNN": [], "GCSAN": [],
          "SGNNHN": ["--step=2"]}


@pytest.mark.parametrize("model", list(MODELS))
def test_cli_trains_and_evaluates_on_cpu(tmp_path, model):
    check_session_cli(model, tmp_path, *MODELS[model])


def test_cli_needs_use_gpu_false_without_card(tmp_path):
    if torch.cuda.is_available():
        return
    r = session_cli("SRGNN", tmp_path)
    assert r.returncode != 0
    assert "RuntimeError" in r.stderr and "--use_gpu=False" in r.stderr
