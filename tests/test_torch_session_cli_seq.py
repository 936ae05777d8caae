"""The three sequence models the port adds (GRU4Rec, NARM, SASRec), and
SRGNN with BPR negatives and uni100 evaluation, train and evaluate on
the fixture through the port's CLI on the CPU (``--use_gpu=False``):
one epoch, finite losses and metrics, the test result and a
checkpoint."""

import pytest

from torch_parity_utils import check_session_cli

CASES = {"GRU4Rec": ("GRU4Rec", ["--hidden_size=32"]),
         "NARM": ("NARM", ["--hidden_size=32"]),
         "SASRec": ("SASRec", []),
         "SRGNN-bpr-uni100": ("SRGNN", [
             "--loss_type=BPR",
             "--train_neg_sample_args={'distribution': 'uniform', "
             "'sample_num': 1}",
             "--eval_args={'split': {'LS': 'valid_and_test'}, "
             "'mode': 'uni100', 'order': 'TO'}"])}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_trains_and_evaluates_on_cpu(tmp_path, case):
    model, extra = CASES[case]
    check_session_cli(model, tmp_path, *extra)
