"""A run with its timed path broken underneath comes out not correct:
for a training cell, a step that leaves its state unchanged, half of
each batch left out with the mean taken over the rest, and a
validation's answer altered where it is produced; for a serving cell,
an answer altered where it is produced.  And the control (the plain
reference in TF32 put in the program's place) reads above a limit of
each cell.  The look for a card is skipped: these run on the CPU."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import tiny
from portbench import calibrate, harness
from portbench import run as runner


def run(bench_all, cell):
    return runner.run_cell(bench_all, cell, 2**31 + 5, 1.0, False,
                           torch.device("cpu"), time.perf_counter(),
                           overrides=tiny(cell))


def shifted_topk(scores, k):
    """Each answer's items replaced by those ranked k+1 … 2k."""
    vals, idx = torch.topk(scores, 2 * k, dim=-1)
    return vals[:, k:], idx[:, k:]


TRAIN = ("lightgcn-gowalla.train", "srgnn-diginetica.train")
SERVE = ("lightgcn-gowalla.serve", "srgnn-diginetica.serve")


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_its_state_unchanged(bench_all, cell, monkeypatch):
    from recbole_gnn_tpu_torch.train.trainer import Trainer

    def frozen(self, params, opt_state, consts, extras, batch, rng, mode=0):
        loss, _ = self.model.calculate_loss(params, consts, extras, batch,
                                            rng, mode=mode)
        return loss.detach()

    monkeypatch.setattr(Trainer, "train_step", frozen)
    res = run(bench_all, cell)
    assert not res["correct"]
    assert res["checks"]["change"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_each_batch_left_out(bench_all, cell, monkeypatch):
    from recbole_gnn_tpu_torch.models import get_model
    name = harness.load_json("configs", cell.split(".")[0])["model"]
    cls = get_model(name)
    orig = cls.calculate_loss

    def half(self, params, consts, extras, batch, rng, mode=0):
        b = dict(batch)
        w = b["weight"].clone()
        w[len(w) // 2:] = 0.0
        b["weight"] = w
        return orig(self, params, consts, extras, b, rng, mode=mode)

    monkeypatch.setattr(cls, "calculate_loss", half)
    res = run(bench_all, cell)
    assert not res["correct"]
    assert not res["checks"]["grad"]["ok"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_validation_answer_altered(bench_all, cell, monkeypatch):
    import recbole_gnn_tpu_torch.eval.evaluator as ev
    monkeypatch.setattr(ev, "masked_topk", shifted_topk)
    res = run(bench_all, cell)
    assert not res["correct"]
    assert not res["checks"]["valid"]["ok"]


@pytest.mark.parametrize("cell", SERVE)
def test_a_served_answer_altered(bench_all, cell, monkeypatch):
    import recbole_gnn_tpu_torch.serve as srv
    monkeypatch.setattr(srv, "masked_topk", shifted_topk)
    res = run(bench_all, cell)
    assert not res["correct"]
    assert not res["checks"]["rank"]["ok"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_the_control_fails_a_limit(bench_all, cell):
    c = {w["name"]: w for w in bench_all["workloads"]}[cell]
    ctx = runner.Context(bench_all, c, 2**31 + 6, 1.0, False,
                         torch.device("cpu"), time.perf_counter(),
                         overrides=tiny(cell))
    fn = (calibrate.train_readings if ctx.mix["runner"] == "train"
          else calibrate.serve_readings)
    out = fn(ctx, control=True)
    control = out["control"]
    assert any(v > ctx.limits[k] for k, v in control.items()
               if k in ctx.limits), control
    # each fault a training cell can have fails a limit too
    for fault in ("fault_half_batch", "fault_answer", "fault_unchanged"):
        if fault in out:
            assert any(v > ctx.limits[k] for k, v in out[fault].items()
                       if k in ctx.limits), \
                (fault, out[fault])
