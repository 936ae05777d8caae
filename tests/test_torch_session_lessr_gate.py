"""The ROADMAP gate for LESSR: from one JAX checkpoint (epoch 0 trained
by the JAX package), both packages train epochs 1 and 2 with the JAX
dropout masks of every step injected (``fold_in(fold_in(k_train,
epoch), step)``, the JAX trainer's per-step key) and give the same
per-epoch losses (rtol 1e-5) and test metrics (|Δ| ≤ 1e-4); each
evaluation takes BatchNorm statistics calibrated on the epoch's first
batch, and the port's final extras hold them as the JAX trainer's do
(rtol 1e-4 / atol 1e-6 after two epochs of Adam steps).  At the
yaml's four layers."""

import numpy as np

from torch_parity_utils import (check_gate, inject_session_keeps,
                                resumed_runs, seq_cfg)


def test_lessr_two_epochs_from_a_jax_checkpoint_match_jax(tmp_path):
    cd = seq_cfg("LESSR", checkpoint_dir=str(tmp_path), eval_step=1,
                 n_layers=4)
    runs = resumed_runs(tmp_path, cd, inject_session_keeps)
    check_gate(runs, loss_rtol=1e-5, metric_atol=1e-4)
    losses = runs["torch"][2]
    assert losses[1] < losses[0]
    got = runs["torch"][0].extras["lessr_bn"]
    want = runs["jax"][0].extras["lessr_bn"]
    assert len(got) == len(want) == 6      # 4 layers, readout, bn_sr
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.cpu().numpy(), np.asarray(b),
                                       rtol=1e-4, atol=1e-6)
