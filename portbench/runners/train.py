"""A training job: ``Trainer.fit`` over the whole training split, with
a validation each epoch, for the window.  ``fit`` saves its checkpoint
only where the traffic file sets ``"saved": true``: that checkpoint,
written on each better validation and compressed on the host, took
4–20 s of a 30 s window and came as often as the validation improved,
so it changed the work from seed to seed and spread the runs far past
any bound (PERF.md).

Set-up builds the program's dataset, loaders, model and trainer from
the configuration, makes the benchmark's weights from the seed, drives
the trainer's own ``train_step`` through the first ``first_steps``
batches of its own training loader (the readings ``correct`` compares:
each step's loss, the first gradient as Adam's state holds it, and the
change of every weight over the steps), runs one validation to warm
its shapes, and hands the same trainer the state through its
checkpoint (``resume_from_checkpoint``).  The window is ``fit`` from
there; the training loader is wrapped so that the harness times each
batch the loop waits for and ends the window at its deadline, between
two steps.  The work counted is every sample of every step issued in
the window, all complete at the closing ``synchronize``.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import harness
from portbench.runners import common
from portbench.reference.common import adam_steps

ADAM_B1 = 0.9
# in the validation's comparison, scores within this share of a row's
# largest magnitude count as tied: float32 scoring lies within ~1e-6 of
# float64 here, TF32 ~1e-4 off
RANK_TIE = 2e-5


class WindowClosed(Exception):
    """Raised from the training loader at the window's deadline."""


class Feed:
    """The training loader as ``fit`` sees it: the same batches, each
    wait timed as the span ``loader``; at the deadline it raises
    :class:`WindowClosed` instead of the next batch."""

    def __init__(self, loader, spans: harness.Spans, tracer):
        self.loader, self.spans, self.tracer = loader, spans, tracer
        self.deadline = math.inf
        self.steps = self.samples = self.steps_traced = 0
        self.issued: list[float] = []     # each step's batch handed over

    @property
    def epoch(self):
        return self.loader.epoch

    @epoch.setter
    def epoch(self, value):
        self.loader.epoch = value

    def __len__(self):
        return len(self.loader)

    def _poll(self):
        if self.tracer is not None:
            self.tracer.poll()
        if time.perf_counter() >= self.deadline:
            raise WindowClosed

    def __iter__(self):
        self._poll()
        it = iter(self.loader)
        while True:
            self._poll()
            with self.spans.span("loader"):
                batch = next(it, None)
            if batch is None:
                return
            self.steps += 1
            self.issued.append(time.perf_counter())
            if self.tracer is not None and self.tracer.active:
                self.steps_traced += 1
            w = batch.get("weight")
            self.samples += int(w.sum()) if w is not None else \
                len(next(iter(batch.values())))
            yield batch


class Setup:
    """The program built and driven through its first steps."""

    def __init__(self, ctx, root: str):
        from recbole_gnn_tpu_torch.eval.evaluator import to_device
        from recbole_gnn_tpu_torch.models import get_model
        from recbole_gnn_tpu_torch.quick_start import (create_dataset,
                                                       data_preparation)
        from recbole_gnn_tpu_torch.train.trainer import get_trainer
        from recbole_gnn_tpu_torch.utils.seed import init_seed
        dev = ctx.device
        self.path = common.write_data(ctx, root)
        self.config = common.port_config(ctx, root)
        init_seed(ctx.seed, True)
        (self.train_loader, train_ds), (self.valid_loader, _), _ = \
            data_preparation(self.config, create_dataset(self.config))
        self.model = get_model(self.config["model"])(self.config, train_ds,
                                                     dev)
        self.trainer = get_trainer(self.config["MODEL_TYPE"],
                                   self.config["model"])(self.config,
                                                         self.model)
        self.shp = ctx.reference.param_shapes(self.model, ctx.cfg["port"])
        p_flat = common.benchmark_params(ctx, self.model, self.shp)
        self.p0 = common.host(p_flat)
        params = harness.tree(p_flat)
        self.extras = self.model.init_extras(
            torch.Generator().manual_seed(ctx.seed))
        opt_state = self.trainer.optimizer.init(params)
        for leaf in p_flat.values():
            leaf.requires_grad_(True)
        rng = torch.Generator().manual_seed(ctx.seed)
        it = iter(self.train_loader)
        self.batches, losses = [], []
        for i in range(int(ctx.mix["first_steps"])):
            batch = next(it)
            self.batches.append(batch)
            losses.append(self.trainer.train_step(
                params, opt_state, self.model.consts, self.extras,
                to_device(batch, dev), rng))
            if i == 0:
                self.grad1 = {k: v / (1 - ADAM_B1) for k, v in common.host(
                    harness.flat(opt_state["m"])).items()}
        del it
        self.losses = [float(v) for v in losses]
        self.p_after = common.host(harness.flat(params))
        self.mode = "full"
        self.valid0 = self.trainer.evaluator.evaluate(
            params, self.extras, self.valid_loader, mode=self.mode)
        self.params, self.opt_state = params, opt_state

    def hand_over(self) -> None:
        """The state into the trainer through its checkpoint; ``fit``
        then continues from epoch 1."""
        from recbole_gnn_tpu_torch.train.checkpoint import save_checkpoint
        t = self.trainer
        save_checkpoint(t.saved_model_file, {
            "params": harness.tree({k: v.detach() for k, v in
                                    harness.flat(self.params).items()}),
            "opt_state": self.opt_state, "extras": self.extras,
            "epoch": np.int64(0), "best_score": np.float64(np.nan),
            "best_epoch": np.int64(-1),
            "config": {"model": self.config["model"],
                       "dataset": self.config["dataset"]}})
        t.resume_from_checkpoint()
        self.params = self.opt_state = None


def reference_steps(R, p0: dict, batches: list, device):
    """(losses, first gradients, weights after the steps) of the plain
    reference from the benchmark's weights on the program's batches."""
    start = {k: R.p.cast(v.to(device)) for k, v in p0.items()}

    def grad_fn(p, t):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = R.loss(leaves, batches[t])
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), {k: g.detach() for k, g in zip(leaves, grads)}

    losses, g1, p_after = adam_steps(start, grad_fn, len(batches))
    return losses, {k: v.double().cpu() for k, v in g1.items()}, \
        {k: v.double().cpu() for k, v in p_after.items()}


def leaf_gap(prog: dict, ref: dict, ref_grad: dict) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger; leaves whose reference gradient is under
    a thousandth of the median leaf's are left out."""
    g = {k: float(torch.linalg.vector_norm(v)) for k, v in ref_grad.items()}
    med_g = float(np.median(list(g.values())))
    keep = [k for k in ref if g[k] >= 1e-3 * med_g]
    r = {k: float(torch.linalg.vector_norm(ref[k])) for k in keep}
    med = float(np.median(list(r.values())))
    return max(abs(float(torch.linalg.vector_norm(prog[k])) - r[k])
               / max(r[k], med, 1e-300) for k in keep)


def compare(readings: dict, ref: dict, p0: dict, n_rows: int) -> dict:
    """The numbers ``correct`` compares, from the program's readings
    (or a control's) and the reference's: the worst step's loss gap over
    the reference's loss; the worst leaf's gap of the first gradient's
    norm and of the steps' change's norm (:func:`leaf_gap`); and how far
    each validation metric lies outside the reference's (low, high)
    over rankings within :data:`RANK_TIE`, in rows (users or
    sessions)."""
    loss = max(abs(a - b) / abs(b) for a, b in
               zip(readings["losses"], ref["losses"]))
    grad = leaf_gap(readings["grad1"], ref["grad1"], ref["grad1"])
    change = leaf_gap({k: readings["p_after"][k] - p0[k] for k in p0},
                      {k: ref["p_after"][k] - p0[k] for k in p0},
                      ref["grad1"])
    valid = max(max(0.0, lo - readings["valid"][k], readings["valid"][k] - hi)
                for k, (lo, hi) in ref["valid"].items()) * n_rows
    return {"loss": loss, "grad": grad, "change": change, "valid": valid}


def window(ctx, s: Setup) -> dict:
    """``fit`` for the window, with the loader, each step and each
    validation timed; the first validation's params kept for the
    check.  The trainer and model are released on return."""
    dev = ctx.device
    trainer = s.trainer
    s.trainer = s.model = None
    feed = Feed(s.train_loader, ctx.spans, ctx.tracer)
    seen = {}
    evaluate, train_step = trainer.evaluator.evaluate, trainer.train_step

    def timed_evaluate(params, extras, loader, mode="full"):
        if ctx.tracer is not None:
            ctx.tracer.poll()
        with ctx.spans.span("evaluate"):
            result = evaluate(params, extras, loader, mode=mode)
        if "valid" not in seen:
            seen["valid"] = ({k: v.detach().clone() for k, v in
                              harness.flat(params).items()}, result)
        return result

    def timed_step(*args, **kwargs):
        with ctx.spans.span("step"):
            return train_step(*args, **kwargs)

    trainer.evaluator.evaluate = timed_evaluate
    trainer.train_step = timed_step
    if ctx.tracer is not None:
        ctx.tracer.prepare()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    feed.deadline = t0 + ctx.seconds
    if ctx.tracer is not None:
        ctx.tracer.begin(t0)
    try:
        trainer.fit(feed, s.valid_loader,
                    saved=bool(ctx.mix.get("saved", False)), verbose=False)
    except WindowClosed:
        pass
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    if ctx.tracer is not None:
        ctx.tracer.stop()
    # steps handed over in each quarter of the window: a run's drift
    # within its window, against the drift between runs
    quarters = np.histogram(np.asarray(feed.issued) - t0, bins=4,
                            range=(0.0, window_s))[0]
    return {"setup_s": setup_s, "window_s": window_s, "feed": feed,
            "quarters": [int(q) for q in quarters],
            "valid": seen.get("valid"), "peak": harness.memory_peak(dev)}


def run(ctx) -> harness.Record:
    dev = ctx.device
    with common.Scratch() as root:
        s = Setup(ctx, root)
        s.hand_over()
        w = window(ctx, s)
        trace = ctx.tracer.summary() if ctx.tracer is not None else None
        gc.collect()                 # the trainer's closures hold a cycle
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        ref_mod = ctx.reference
        log = ref_mod.load_log(s.path, ctx.cfg["port"], ctx.seed)
        shapes = ref_mod.shapes(log, ctx.cfg["port"])
        R = ref_mod.Reference(log, ctx.cfg["port"], dev, "f64")
        checks = {"shape": float(sum(shapes[k] != v
                                     for k, v in s.shp.items()
                                     if k in shapes)),
                  "batches": float(sum(R.batch_faults(b)
                                       for b in s.batches))}
        ref = dict(zip(("losses", "grad1", "p_after"),
                       reference_steps(R, s.p0, s.batches, dev)))
        # the window's first validation; the set-up one if it had none
        params_v, result_v = w["valid"] or (s.p_after, s.valid0)
        k = int(ctx.cfg["port"]["topk"][0])
        _, n_rows, ref["valid"] = R.validation(params_v, k, tol=RANK_TIE)
        readings = {"losses": s.losses, "grad1": s.grad1,
                    "p_after": s.p_after, "valid": result_v}
        checks.update(compare(readings, ref, s.p0, n_rows))
    feed = w["feed"]
    work = {"steps": feed.steps, "samples": feed.samples,
            "steps_traced": feed.steps_traced,
            "steps_by_quarter": w["quarters"],
            "held_s": ctx.tracer.held_s if ctx.tracer else 0.0}
    if trace is not None and feed.steps_traced:
        # the device's time per step under the profiler, against which
        # the untraced steps' pace shows how far tracing idles the card
        work["busy_ms_per_traced_step"] = \
            trace["busy_s"] / feed.steps_traced * 1e3
    return harness.Record(
        setup_s=w["setup_s"], window_s=w["window_s"], attempted=feed.steps,
        failed=int(not all(map(math.isfinite, s.losses))),
        work=work,
        spans=dict(ctx.spans.durations), trace=trace, shapes=shapes,
        checks=checks, cfg=ctx.cfg, device=dev,
        memory_peak_bytes=w["peak"], base=ctx.base, reference=ref_mod)
