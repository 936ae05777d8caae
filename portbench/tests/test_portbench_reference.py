"""Each plain reference against the port at a tiny size on the CPU:
the reference's reading of the log against the program's dataset, its
loss and gradients against the model's, and whole runs of each cell
whose checks hold."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from conftest import tiny
from portbench import harness
from portbench import run as runner
from portbench.runners import common, train

CELLS = ("lightgcn-gowalla.train", "srgnn-diginetica.train",
         "lightgcn-gowalla.serve", "srgnn-diginetica.serve")


def context(bench_all, cell, seed=11):
    c = {w["name"]: w for w in bench_all["workloads"]}[cell]
    return runner.Context(bench_all, c, seed, 1.0, False, torch.device("cpu"),
                          time.perf_counter(), overrides=tiny(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_of_each_cell_is_correct(bench_all, cell):
    res = runner.run_cell(bench_all, cell, 2**31 + 99, 1.0, False,
                          torch.device("cpu"), time.perf_counter(),
                          overrides=tiny(cell))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS[:2])
def test_reference_loss_and_gradients_match_the_model(bench_all, cell,
                                                     tmp_path):
    ctx = context(bench_all, cell)
    s = train.Setup(ctx, str(tmp_path))
    log = ctx.reference.load_log(s.path, ctx.cfg["port"], ctx.seed)
    ref = ctx.reference.Reference(log, ctx.cfg["port"], ctx.device, "f64")
    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    params = {k: v.float().requires_grad_(True) for k, v in s.p0.items()}
    batch = s.batches[0]
    loss, _ = s.model.calculate_loss(harness.tree(params), s.model.consts,
                                     s.extras, to_device(batch, ctx.device),
                                     None)
    grads = torch.autograd.grad(loss, list(params.values()))
    rp = {k: v.double().requires_grad_(True) for k, v in s.p0.items()}
    rloss = ref.loss(rp, batch)
    rgrads = torch.autograd.grad(rloss, list(rp.values()))
    assert float(loss.detach()) == pytest.approx(float(rloss.detach()),
                                                 rel=1e-6)
    for g, rg in zip(grads, rgrads):
        np.testing.assert_allclose(g.double().numpy(), rg.numpy(),
                                   rtol=1e-4, atol=1e-6 * float(
                                       rg.abs().max()))
    # the reference reads the program's batches as training rows
    assert sum(ref.batch_faults(b) for b in s.batches) == 0


def test_general_split_matches_the_program(bench_all, tmp_path):
    ctx = context(bench_all, "lightgcn-gowalla.train")
    from recbole_gnn_tpu_torch.quick_start import create_dataset
    path = common.write_data(ctx, str(tmp_path))
    config = common.port_config(ctx, str(tmp_path))
    splits = create_dataset(config).build()
    log = ctx.reference.load_log(path, ctx.cfg["port"], ctx.seed)
    for part, ds in enumerate(splits):
        u, i = ds.user_item_arrays()
        ru, ri = log.pairs(part)
        assert sorted(zip(u.tolist(), i.tolist())) == \
            sorted(zip(ru.tolist(), ri.tolist()))


def test_session_samples_match_the_program(bench_all, tmp_path):
    ctx = context(bench_all, "srgnn-diginetica.train")
    from recbole_gnn_tpu_torch.quick_start import (create_dataset,
                                                   data_preparation)
    path = common.write_data(ctx, str(tmp_path))
    config = common.port_config(ctx, str(tmp_path))
    splits = data_preparation(config, create_dataset(config))
    log = ctx.reference.load_log(path, ctx.cfg["port"], ctx.seed)
    for part, (_, ds) in enumerate(splits):
        seqs, lens, tgt = log.samples(part)
        np.testing.assert_array_equal(ds.inter["item_id_list"], seqs)
        np.testing.assert_array_equal(ds.inter["item_length"], lens)
        np.testing.assert_array_equal(ds.inter["item_id"], tgt)
