"""Trainer — step loop, early stopping, checkpoints.

Port of ``recbole_gnn_tpu/train/trainer.py``.  Model-specific behaviour
comes through model hooks, not subclasses: ``epoch_start`` (extras
refresh), ``loss_mode`` (warm-up variants) and ``serving_calibrate``.

One optimizer step per batch: ``model.calculate_loss`` (on a sparse
graph: K forward SpMM kernels), ``torch.autograd.grad`` (K transpose
SpMM kernels), then the functional in-place update of
``train/optim.py``; on the card, once captured, the whole step replays
as one CUDA graph (``train/step_graph.py``).  The loss is summed on the
device and read once per epoch; batches go to the device as int64
tensors.  ``epoch_scan`` (a TPU dispatch knob) is accepted and runs the
same per-step loop.

A fresh ``fit`` draws its params from a ``torch.Generator`` seeded with
``seed`` (the draws differ from the JAX package's; parity runs start
both packages from one checkpoint); each epoch gets a generator of its
own, seeded from (seed, epoch), so a resumed run replays the same
stream.

With ``mesh_shape`` the trainer runs on every rank of the mesh
(``parallel/``): the ``tp``-row-sharded tables are padded to the shard
multiple and each rank keeps its block and its ``dp`` slice of every
step's batch (``parallel/sharded_train.py``).  Every rank draws the same
global batches from the same seeds and slices them, evaluates the
whole logical state (item-sharded over ``tp``) and reaches the same
decisions; only the mesh's rank 0 logs, writes the jsonl, tensorboard
and checkpoints, which hold the logical (unpadded) state.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from recbole_gnn_tpu_torch.eval.evaluator import Evaluator, to_device
from recbole_gnn_tpu_torch.parallel.mesh import (in_mesh, is_main, make_mesh,
                                                 mesh_barrier, mesh_broadcast)
from recbole_gnn_tpu_torch.parallel.sharded_train import (
    logical_state, make_sharded_train_step, pad_opt_state, pad_tables,
    place_batch, place_state, shard_params_spec, table_pad_plan)
from recbole_gnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   params_from_numpy,
                                                   save_checkpoint)
from recbole_gnn_tpu_torch.train.optim import (make_optimizer, tree_leaves,
                                               tree_map, tree_unflatten)
from recbole_gnn_tpu_torch.train.step_graph import StepGraphs
from recbole_gnn_tpu_torch.utils import trace
from recbole_gnn_tpu_torch.utils.logging import JsonlSink, get_logger


def _epoch_generator(seed: int, epoch: int) -> torch.Generator:
    return torch.Generator().manual_seed((seed + 1) * 1_000_003 + epoch)


class Trainer:

    def __init__(self, config, model):
        self.config = config
        self.model = model
        self.device = model.device
        self.logger = get_logger()
        self.epochs = int(config.get("epochs", 300))
        self.eval_step = max(1, int(config.or_default("eval_step", 1)))
        self.stopping_step = int(config.get("stopping_step", 10))
        self.valid_metric = str(config.or_default("valid_metric",
                                                  "MRR@10")).lower()
        self.valid_metric_bigger = config["valid_metric_bigger"] is not False
        clip = config["clip_grad_norm"]
        self._clip = float(clip["max_norm"]) if isinstance(clip, dict) \
            else clip
        self.optimizer = make_optimizer(
            learner=config.or_default("learner", "adam"),
            lr=float(config.or_default("learning_rate", 1e-3)),
            weight_decay=float(config.get("weight_decay", 0.0)),
            clip_grad_norm=self._clip)
        ckpt_dir = config.get("checkpoint_dir", "saved/")
        self.saved_model_file = os.path.join(
            ckpt_dir, f"{config['model']}-{config['dataset']}.ckpt")
        self.train_timings: list[float] = []
        self._graphs = StepGraphs(self.device)
        self._mesh = None
        # the mesh's state: tp pad plan ({}: none), row-sharding spec
        self._pad_plan: dict = {}
        self._spec = None
        if config["mesh_shape"]:
            self._mesh = make_mesh(config["mesh_shape"])
            if not in_mesh(self._mesh):
                raise ValueError(
                    f"mesh_shape {config['mesh_shape']} leaves this rank "
                    "out of the mesh; launch as many ranks as the mesh has")
        self._main = self._mesh is None or is_main(self._mesh)
        self.evaluator = Evaluator(config, model, mesh=self._mesh)
        self.jsonl = JsonlSink(config["metrics_log_path"] if self._main
                               else None)
        self._profile_dir = config["profile_trace_dir"]
        self._tb = None
        # trained/restored state; set by fit() or resume_from_checkpoint()
        self.params = None
        self.extras = None
        self.opt_state = None
        self._resume_epoch = None
        self._resume_best = None
        if config["tensorboard_dir"] and self._main:
            # optional TB scalars, best-effort as in the JAX package
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(config["tensorboard_dir"])
            except (ImportError, OSError):
                self._tb = None

    # -- one step -------------------------------------------------------

    def train_step(self, params, opt_state, consts, extras, batch, rng,
                   mode: int = 0) -> torch.Tensor:
        """Loss, gradients and one in-place optimizer update on a device
        batch; returns the detached loss (a device scalar).  On a CUDA
        device without a mesh the step is captured in a CUDA graph once
        its first eager step shows that it can be, and replayed from
        then on (``train/step_graph.py``); the span ``step`` counts
        ``steps`` and ``replayed``."""
        with trace.span("step"):
            trace.count("steps", 1)
            if self.device.type != "cuda" or self._mesh is not None:
                return self._eager_step(params, opt_state, consts, extras,
                                        batch, rng, mode)
            return self._graphs.step(self._eager_step, params, opt_state,
                                     consts, extras, batch, rng, mode)

    def _eager_step(self, params, opt_state, consts, extras, batch, rng,
                    mode: int) -> torch.Tensor:
        leaves = tree_leaves(params)
        with trace.span("forward"):
            loss, _aux = self.model.calculate_loss(
                params, consts, extras, batch, rng, mode=mode)
        with trace.span("backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
        with trace.span("optimizer"):
            self.optimizer.update(tree_unflatten(params, grads),
                                  opt_state, params)
        return loss.detach()

    # -- training loop --------------------------------------------------

    def fit(self, train_loader, valid_loader=None, saved: bool = True,
            verbose: bool = True, callback=None, resume: bool = False):
        """Train.  With ``resume=True`` (or after an explicit
        ``resume_from_checkpoint()``) training continues from the
        restored state at the checkpointed epoch + 1; the loader's
        shuffle stream is realigned and the best score is restored, so a
        post-resume validation never overwrites a better saved model.

        The whole call is the span ``fit``, each epoch's batch loop the
        span ``epoch`` and the model's ``epoch_start`` hook before it the
        span ``epoch_start`` (``utils/trace.py``); the jsonl ``train_epoch``
        event's ``seconds`` is that span's, and its ``spans`` are the
        ``{path: [count, total_ms]}`` of the spans closed since the
        previous ``train_epoch`` event (this epoch's loop and the
        validation after the previous epoch)."""
        with trace.span("fit"):
            return self._fit(train_loader, valid_loader, saved, verbose,
                             callback, resume)

    def _fit(self, train_loader, valid_loader, saved, verbose, callback,
             resume):
        cfg = self.config
        seed = int(cfg.get("seed", 2020))
        start_epoch = 0
        best_score = None
        best_result: dict = {}
        best_epoch = -1
        if resume and self._resume_epoch is None:
            if os.path.isfile(self.saved_model_file):
                self.resume_from_checkpoint()
            else:
                self.logger.info(
                    f"resume: no checkpoint at {self.saved_model_file!r} "
                    "— starting fresh")
        if self._resume_epoch is not None:
            params, extras = self.params, self.extras
            opt_state = (self.opt_state if self.opt_state is not None
                         else self.optimizer.init(params))
            start_epoch = self._resume_epoch + 1
            if hasattr(train_loader, "epoch"):
                train_loader.epoch = start_epoch
            if self._resume_best is not None:
                rs, re_ = self._resume_best
                if rs is not None and np.isfinite(rs):
                    best_score, best_epoch = float(rs), int(re_)
            self._resume_epoch = None
            self._resume_best = None
        else:
            gen = torch.Generator().manual_seed(seed)
            params = self.model.init_params(gen)
            extras = self.model.init_extras(gen)
            opt_state = self.optimizer.init(params)
        consts = self.model.consts
        step_fns: dict = {}
        if self._mesh is not None:
            # pad the non-dividing tables to the tp shard multiple (the
            # step slices them back), then keep this rank's blocks
            self._pad_plan = table_pad_plan(params, self._mesh)
            params = pad_tables(params, self._pad_plan)
            opt_state = pad_opt_state(opt_state, self._pad_plan)
            self._spec = shard_params_spec(params, self._mesh)
            params, opt_state = place_state(params, opt_state, self._mesh,
                                            self._spec)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        verbose = verbose and self._main

        cur_step = 0
        calib_batch = None
        mark = trace.totals()
        for epoch in range(start_epoch, self.epochs):
            rng = _epoch_generator(seed, epoch)
            with trace.span("epoch_start"):
                extras = self.model.epoch_start(
                    epoch, self._logical(params)[0], consts, extras, rng)
            mode = int(self.model.loss_mode(epoch))
            if mode not in step_fns:
                step_fns[mode] = self._step_fn(mode)
            prof = None
            if self._profile_dir and epoch == 1 and self._main:
                # skip epoch 0 (first-touch allocations) and trace one
                prof = torch.profiler.profile(activities=self._activities())
                prof.start()
            loss_sum = None
            n_examples = 0
            with trace.span("epoch") as ep:
                for i, batch in enumerate(train_loader):
                    if i == 0:
                        calib_batch = batch   # host copy
                    with trace.span("to_device"):
                        dev_batch = self._place(batch)
                    loss = step_fns[mode](params, opt_state, consts, extras,
                                          dev_batch, rng)
                    # running device-scalar sum, read once at epoch end
                    loss_sum = loss if loss_sum is None else loss_sum + loss
                    w = batch.get("weight")
                    n_examples += int(w.sum()) if w is not None else \
                        len(next(iter(batch.values())))
                    if verbose and i and i % 500 == 0:
                        ms = (time.perf_counter_ns() - ep.t0) / i * 1e-6
                        self.logger.info(
                            f"epoch {epoch} step {i}: {ms:.0f} ms/step")
                total = float(loss_sum) if loss_sum is not None else 0.0
            dt = ep.seconds
            if prof is not None:
                prof.stop()
                os.makedirs(self._profile_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(self._profile_dir, "epoch1.trace.json"))
            self.train_timings.append(dt)
            if not math.isfinite(total):
                raise ValueError(f"NaN/Inf loss at epoch {epoch}")
            self.jsonl.write({"event": "train_epoch", "epoch": epoch,
                              "loss": total, "seconds": dt,
                              "examples_per_s": n_examples / max(dt, 1e-9),
                              "spans": trace.since(mark)})
            mark = trace.totals()
            if self._tb is not None:
                self._tb.add_scalar("Loss/train", total, epoch)
            if verbose:
                self.logger.info(
                    f"epoch {epoch} : train loss {total:.4f} [{dt:.2f}s, "
                    f"{n_examples / max(dt, 1e-9):.0f} ex/s]")

            if valid_loader is not None and (epoch + 1) % self.eval_step == 0:
                lp, lo = self._logical(params, opt_state)
                eval_extras = self._calibrated_extras(lp, consts, extras,
                                                      calib_batch)
                result = self.evaluator.evaluate(lp, eval_extras,
                                                 valid_loader,
                                                 mode=_eval_mode(cfg))
                if self._mesh is not None:
                    # one decision for every rank: the mesh rank 0's
                    result = mesh_broadcast(result, self._mesh)
                score = result.get(self.valid_metric,
                                   next(iter(result.values()), 0.0))
                self.jsonl.write({"event": "valid", "epoch": epoch,
                                  "seconds": self.evaluator.last_seconds,
                                  **result})
                if self._tb is not None:
                    self._tb.add_scalar("Valid_score", score, epoch)
                if verbose:
                    self.logger.info(f"epoch {epoch} : valid {result}")
                improved = (best_score is None or
                            (score > best_score if self.valid_metric_bigger
                             else score < best_score))
                if improved:
                    best_score, best_result, best_epoch = score, result, epoch
                    cur_step = 0
                    if saved:
                        self._save(lp, lo, eval_extras, epoch,
                                   best_score, best_epoch)
                else:
                    cur_step += 1
                    # early stopping stays armed but not live until
                    # stopping_min_epochs
                    min_ep = int(cfg.get("stopping_min_epochs", 0))
                    if cur_step >= self.stopping_step and \
                            epoch + 1 >= min_ep:
                        if verbose:
                            self.logger.info(
                                f"early stop at epoch {epoch} "
                                f"(best epoch {best_epoch})")
                        break
            elif valid_loader is None and saved:
                lp, lo = self._logical(params, opt_state)
                self._save(lp, lo,
                           self._calibrated_extras(lp, consts, extras,
                                                   calib_batch), epoch)
            if callback is not None:
                callback(epoch, self._logical(params)[0], extras)

        # the logical state, checkpoint-compatible on any topology
        params, opt_state = self._logical(params, opt_state)
        self.params = tree_map(torch.Tensor.detach, params)
        self.extras = self._calibrated_extras(params, consts, extras,
                                              calib_batch)
        self.opt_state = opt_state
        if best_score is None:
            best_score, best_result = 0.0, {}
        if self._tb is not None:
            self._tb_hparams(best_score, best_result)
        return best_score, best_result

    def _step_fn(self, mode: int):
        """The step of loss mode ``mode``: :meth:`train_step`, or over a
        mesh the sharded step on this rank's blocks."""
        if self._mesh is None:
            return lambda *a: self.train_step(*a, mode=mode)
        return make_sharded_train_step(
            self.model, self.optimizer, self._mesh, self._spec, mode=mode,
            pad_plan=self._pad_plan, clip_grad_norm=self._clip)

    def _place(self, batch: dict) -> dict:
        """A host batch on the device: over a mesh, this rank's dp
        slice of it."""
        if self._mesh is not None:
            batch = place_batch(batch, self._mesh)
        return to_device(batch, self.device)

    def _logical(self, params, opt_state=None):
        """(params, opt_state) whole and unpadded: over a mesh, gathered
        from every rank's blocks."""
        if self._mesh is None:
            return params, opt_state
        return logical_state(params, opt_state, self._spec, self._mesh,
                             self._pad_plan)

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _tb_hparams(self, best_score, best_result):
        """hparams export at fit end ([recbole] trainer parity); a
        failure is logged and never fails training."""
        hparams = {k: v for k, v in self.config.as_dict().items()
                   if isinstance(v, (int, float, str, bool))}
        metrics = {f"hparam/{k}": float(v) for k, v in best_result.items()}
        metrics["hparam/best_valid_score"] = float(best_score)
        try:
            self._tb.add_hparams(hparams, metrics)
            self._tb.flush()
        except Exception:   # noqa: BLE001 — best-effort sink
            self.logger.exception("tensorboard hparams export failed")

    def _calibrated_extras(self, params, consts, extras, calib_batch):
        """Optional model hook: freeze eval-time population statistics
        from a sample train batch.  No-op for models without
        ``serving_calibrate``."""
        fn = getattr(self.model, "serving_calibrate", None)
        if fn is None or calib_batch is None:
            return extras
        with torch.no_grad():
            return fn(params, consts, extras,
                      to_device(calib_batch, self.device))

    # -- evaluation -----------------------------------------------------

    def evaluate(self, eval_loader, load_best_model: bool = True,
                 params=None, extras=None) -> dict:
        if params is None:
            if load_best_model and os.path.isfile(self.saved_model_file):
                state = load_checkpoint(self.saved_model_file)
                params = params_from_numpy(state["params"], self.device)
                extras = params_from_numpy(state.get("extras") or {},
                                           self.device)
            else:
                if self.params is None:
                    raise RuntimeError(
                        "Trainer.evaluate() called before fit() with no "
                        f"checkpoint at {self.saved_model_file!r}: train "
                        "first, call resume_from_checkpoint(), or pass "
                        "params= explicitly")
                params, extras = self.params, self.extras
        return self.evaluator.evaluate(params, extras or {}, eval_loader,
                                       mode=_eval_mode(self.config))

    def _save(self, params, opt_state, extras, epoch,
              best_score=None, best_epoch=-1):
        """Write the (logical) state; over a mesh rank 0 writes and
        every rank waits for it."""
        if not self._main:
            mesh_barrier(self._mesh)
            return
        save_checkpoint(self.saved_model_file, {
            "params": params, "opt_state": opt_state, "extras": extras,
            "epoch": np.int64(epoch),
            # NaN sentinel = "no validation score yet"
            "best_score": np.float64(best_score if best_score is not None
                                     else np.nan),
            "best_epoch": np.int64(best_epoch),
            "config": {"model": self.config["model"],
                       "dataset": self.config["dataset"]},
        })
        if self._mesh is not None:
            mesh_barrier(self._mesh)

    def resume_from_checkpoint(self, path: str | None = None) -> int:
        """Restore params/opt/extras (written by either package); a
        following ``fit()`` continues from the checkpointed epoch + 1."""
        state = load_checkpoint(path or self.saved_model_file)
        self.params = params_from_numpy(state["params"], self.device)
        self.extras = params_from_numpy(state.get("extras") or {},
                                        self.device)
        opt = state.get("opt_state")
        self.opt_state = (params_from_numpy(opt, self.device)
                          if opt is not None else None)
        epoch = int(state.get("epoch", -1))
        self._resume_epoch = epoch
        bs = state.get("best_score")
        self._resume_best = (
            (float(bs), int(state.get("best_epoch", -1)))
            if bs is not None and np.isfinite(bs) else None)
        return epoch


def _eval_mode(config) -> str:
    mode = (config.get("eval_args", {}).get("mode")) or "full"
    return "full" if mode == "full" else "candidates"


def get_trainer(model_type, model_name):
    """(type, name) → trainer class; one Trainer serves every model."""
    return Trainer
