"""The ROADMAP gate for the session family: from one JAX checkpoint
(epoch 0 trained by the JAX package), both packages train epochs 1 and
2 of SRGNN and of SASRec (SASRec with the JAX dropout masks of every
step injected: ``fold_in(fold_in(k_train, epoch), step)``, the JAX
trainer's per-step key) and give the same per-epoch losses (rtol 1e-5)
and test metrics (|Δ| ≤ 1e-4)."""

import pytest

from torch_parity_utils import (check_gate, inject_session_keeps,
                                resumed_runs, seq_cfg)


@pytest.mark.parametrize("model", ["SRGNN", "SASRec"])
def test_two_epochs_from_a_jax_checkpoint_match_jax(tmp_path, model):
    cd = seq_cfg(model, checkpoint_dir=str(tmp_path), eval_step=1)
    inject = (inject_session_keeps if model == "SASRec"
              else (lambda *a: None))
    runs = resumed_runs(tmp_path, cd, inject)
    check_gate(runs, loss_rtol=1e-5, metric_atol=1e-4)
    # the resumed port run trained: its epoch losses fall
    losses = runs["torch"][2]
    assert losses[1] < losses[0]
