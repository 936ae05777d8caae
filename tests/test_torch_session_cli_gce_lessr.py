"""GCE-GNN and LESSR train and evaluate on the fixture through the
port's CLI on the CPU (``--use_gpu=False``): one epoch, finite losses
and metrics, the test result and a checkpoint (LESSR with one EOPA and
one SGAT layer)."""

import pytest

from torch_parity_utils import check_session_cli


@pytest.mark.parametrize("model,extra", [("GCEGNN", []),
                                         ("LESSR", ["--n_layers=2"])])
def test_cli_trains_and_evaluates_on_cpu(tmp_path, model, extra):
    check_session_cli(model, tmp_path, *extra)
