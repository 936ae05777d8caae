"""The ROADMAP gate for the session family: from one JAX checkpoint
(epoch 0 trained by the JAX package), both packages train epochs 1 and
2 of SRGNN and of SASRec (SASRec with the JAX dropout masks of every
step injected: ``fold_in(fold_in(k_train, epoch), step)``, the JAX
trainer's per-step key) and give the same per-epoch losses (rtol 1e-5)
and test metrics (|Δ| ≤ 1e-4)."""

import jax
import pytest

from torch_parity_utils import (check_gate, resumed_runs, seq_cfg,
                                session_keeps)


def _inject_keeps(tm, jm, seed):
    """Feed each port step the keep masks of the JAX step it mirrors."""
    k_train = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    at = {"epoch": None, "step": 0}
    real_start, real_loss = tm.epoch_start, tm.calculate_loss

    def epoch_start(epoch, params, consts, extras, rng):
        at.update(epoch=epoch, step=0)
        return real_start(epoch, params, consts, extras, rng)

    def calculate_loss(params, consts, extras, batch, rng, mode=0):
        key = jax.random.fold_in(jax.random.fold_in(k_train, at["epoch"]),
                                 at["step"])
        at["step"] += 1
        return real_loss(params, consts, extras, batch, rng, mode=mode,
                         keeps=session_keeps(type(tm).__name__, jm, batch,
                                             key))

    tm.epoch_start = epoch_start
    tm.calculate_loss = calculate_loss


@pytest.mark.parametrize("model", ["SRGNN", "SASRec"])
def test_two_epochs_from_a_jax_checkpoint_match_jax(tmp_path, model):
    cd = seq_cfg(model, checkpoint_dir=str(tmp_path), eval_step=1)
    inject = _inject_keeps if model == "SASRec" else (lambda *a: None)
    runs = resumed_runs(tmp_path, cd, inject)
    check_gate(runs, loss_rtol=1e-5, metric_atol=1e-4)
    # the resumed port run trained: its epoch losses fall
    losses = runs["torch"][2]
    assert losses[1] < losses[0]
