"""The training step captured once in a CUDA graph and replayed.

An eager step of ``Trainer.train_step`` issues every kernel of the
forward, the backward and the optimizer from the host, one launch at a
time (LightGCN at the Gowalla shape: 175 launches for 1.3 device ms, 3
to 7 host ms to issue them).  A replayed CUDA graph issues the same
kernels, with the same arguments and in the same order, in one launch.

A graph belongs to one *state*: the loss mode, the objects of every
leaf of ``params``, ``opt_state``, ``consts`` and ``extras``, the
batch's keys, shapes and dtypes, and the device.  The epoch's generator
is not part of it.  A state is captured only where its observed eager
step shows that it can be (the trainer sends only CUDA steps without a
mesh here):

* the step drew nothing from a host generator: the epoch's generator
  and the process's default one keep their states across it (a graph
  would replay one draw forever);
* the step made no synchronizing call (none is reported under
  ``torch.cuda.set_sync_debug_mode("warn")``; PyTorch calls that mode a
  prototype that does not see every sync, and a sync it misses fails
  the capture, which then raises).

A new state's first eager step is observed (span ``observe``): a
clean step admits the state, and its next step is captured (span
``capture``) and replayed; a draw or a sync leaves it eager.  A capture
that fails once its state was admitted raises.  A replay (span
``replay``) copies the batch into the graph's input tensors, replays,
and returns a copy of the graph's loss (a caller may keep each step's
loss).  The kernel wrappers count the launches they issue, in the eager
steps and in the capture; a replay launches through none of them.  At
most one graph per loss mode is kept: a new state drops the old one
with its memory pool.

Spans: ``observe``, ``capture`` and ``replay`` under the trainer's
``step``; the trainer's counters ``captures`` and ``replayed`` count the
captures and the replays.
"""

from __future__ import annotations

import warnings

import torch

from recbole_gnn_tpu_torch.train.optim import tree_leaves
from recbole_gnn_tpu_torch.utils import trace
from recbole_gnn_tpu_torch.utils.logging import get_logger

# the warning torch.cuda.set_sync_debug_mode("warn") gives for a sync,
# and the one it gives when set (said in this module's docstring)
_SYNC_WARNING = "called a synchronizing CUDA operation"
_PROTOTYPE_WARNING = "Synchronization debug mode is a prototype"


class _State:
    """One state: its key and leaves (held, so that no other object
    takes their ids), what its observed step showed and, once captured,
    its graph, input tensors and loss."""

    def __init__(self, key: tuple, leaves: list):
        self.key, self.leaves = key, leaves
        self.admitted = self.eager = False
        self.graph = self.inputs = self.loss = None

    def leave_eager(self, mode: int, why: str) -> None:
        self.eager = True
        get_logger().info(f"training step (loss mode {mode}) stays eager: "
                          f"{why}")


def _host_generators(rng) -> list[torch.Generator]:
    gens = [torch.default_generator]
    if isinstance(rng, torch.Generator) and rng is not gens[0]:
        gens.append(rng)
    return gens


class StepGraphs:
    """The captured steps of one trainer, one per loss mode.  ``step``
    takes the trainer's eager step (``eager(params, opt_state, consts,
    extras, batch, rng, mode)`` → the detached loss) and its arguments."""

    def __init__(self, device: torch.device):
        self.device = device
        self._states: dict[int, _State] = {}

    def step(self, eager, params, opt_state, consts, extras, batch: dict,
             rng, mode: int) -> torch.Tensor:
        leaves = [*tree_leaves(params), *tree_leaves(opt_state),
                  *tree_leaves(consts), *tree_leaves(extras)]
        key = (mode, self.device, tuple(map(id, leaves)),
               tuple((k, v.shape, v.dtype) for k, v in batch.items()))
        st = self._states.get(mode)
        if st is None or st.key != key:
            # a new state; the old one's graph and pool go with it
            st = self._states[mode] = _State(key, leaves)
        args = (params, opt_state, consts, extras)
        if st.graph is None and st.admitted:
            self._capture(st, eager, args, batch, rng, mode)
        if st.graph is not None:
            return self._replay(st, batch)
        if st.eager:
            return eager(*args, batch, rng, mode)
        return self._observe(st, eager, args, batch, rng, mode)

    def _observe(self, st: _State, eager, args, batch, rng, mode):
        gens = _host_generators(rng)
        before = [g.get_state() for g in gens]
        with trace.span("observe"), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            warnings.filterwarnings("ignore", _PROTOTYPE_WARNING)
            debug = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                loss = eager(*args, batch, rng, mode)
            finally:
                torch.cuda.set_sync_debug_mode(debug)
        synced = False
        for w in caught:
            if _SYNC_WARNING in str(w.message):
                synced = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        if any(not torch.equal(b, g.get_state())
               for b, g in zip(before, gens)):
            st.leave_eager(mode, "it draws from a host generator")
        elif synced:
            st.leave_eager(mode, "it makes a synchronizing call")
        else:
            st.admitted = True
        return loss

    @staticmethod
    def _capture(st: _State, eager, args, batch, rng, mode):
        trace.count("captures", 1)
        with trace.span("capture"):
            inputs = {k: v.clone() for k, v in batch.items()}
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    loss = eager(*args, inputs, rng, mode)
            except RuntimeError as exc:
                raise RuntimeError(
                    f"capturing the training step (loss mode {mode}) in a "
                    f"CUDA graph failed, though its eager step drew nothing "
                    f"and made no synchronizing call: {exc}") from exc
            st.graph, st.inputs, st.loss = graph, inputs, loss

    @staticmethod
    def _replay(st: _State, batch: dict) -> torch.Tensor:
        trace.count("replayed", 1)
        with trace.span("replay"):
            for k, v in batch.items():
                st.inputs[k].copy_(v)
            st.graph.replay()
            return st.loss.clone()
