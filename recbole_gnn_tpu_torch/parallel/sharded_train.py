"""Sharded training step — dp batch slices and tp row-sharded tables.

Port of ``recbole_gnn_tpu/parallel/sharded_train.py``.  The JAX step is
the single-chip step jitted with sharding annotations, GSPMD inserting
the collectives; here every rank runs the step on its own pieces and
the collectives are written out:

* each rank holds its ``tp`` row block of every row-sharded table
  (``user_emb`` / ``item_emb``, 2-D, padded to the shard multiple by
  :func:`table_pad_plan`) and of Adam's moments, and takes its ``dp``
  slice of each step's batch (:func:`place_state`, :func:`place_batch`);
* the step all-gathers the tables over ``tp`` (its backward: the
  reduce-scatter of the cotangents), slices off the pad rows and runs
  the model on the logical tables;
* the losses reduce their batch sums over ``dp`` (``comm.batch_sum``:
  BPR's Σw, EmbLoss's Σe² before its square root) and gather in-batch
  rows, so the loss is the global batch's, the same on every rank;
* then the port's optimizer (``train/optim.py``) updates the local
  blocks.

How each gradient is summed exactly once.  Every rank back-propagates
``L / world`` (``world`` = the mesh's ranks), with ``L`` the global loss
it computed.  Each collective inside autograd back-propagates its
adjoint: the table all-gather's reduce-scatter over ``tp``, the loss
all-reduce's all-reduce over ``dp``, the edge-sharded SpMM's
all-gather's reduce-scatter over its axis (``parallel/sharded_spmm.py``
— its partial dx is not reduced there).  So a rank's gradient with
respect to its copy of a tensor is its share of the total, and the
total is the sum over the ranks that hold a copy: the step all-reduces
each replicated parameter's gradient over every mesh axis, and each
row-sharded table's over every axis but ``tp`` (the reduce-scatter has
summed ``tp``).  Σ over ranks of ∂(L / world) = ∂L.  Global-norm
clipping sums the sharded tables' squares over ``tp`` first.
"""

from __future__ import annotations

import logging
import math

import torch

from recbole_gnn_tpu_torch.parallel.comm import (all_gather_rows, all_reduce_,
                                                 batch_reduction)
from recbole_gnn_tpu_torch.parallel.mesh import (axis_group, axis_size,
                                                 batch_sharding,
                                                 embedding_sharding)
from recbole_gnn_tpu_torch.train.optim import (tree_leaves, tree_map,
                                               tree_unflatten)

TABLE_KEYS = ("user_emb", "item_emb")


def shard_params_spec(params, mesh, table_axis: str = "tp",
                      table_keys: tuple[str, ...] = TABLE_KEYS):
    """A tree shaped like ``params``: True where the leaf is row-sharded
    over ``table_axis`` (a 2-D table of ``table_keys`` whose rows divide
    the shard count), False where it is replicated."""
    n_shards = axis_size(mesh, table_axis)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if key in table_keys and node.dim() == 2 and n_shards > 1:
            if node.shape[0] % n_shards == 0:
                return True
            logging.getLogger("recbole_gnn_tpu_torch").warning(
                "table %r (%d rows) not divisible by %s=%d — "
                "REPLICATED instead of row-sharded (pad the table to "
                "a shard multiple to regain tp memory scaling)",
                key, node.shape[0], table_axis, n_shards)
        return False

    return walk(params)


def table_pad_plan(params, mesh, table_axis: str = "tp",
                   table_keys: tuple[str, ...] = TABLE_KEYS
                   ) -> dict[str, tuple[int, int]]:
    """{table key: (logical_rows, padded_rows)} for every 2-D table of
    ``table_keys`` whose rows don't divide the ``table_axis`` shard
    count.  Tables are zero-padded at the step boundary only: the model
    sees the logical table, pad rows get zero gradient and stay zero
    under Adam, and checkpoints hold the logical state.  Empty ⇒ nothing
    to pad."""
    n_shards = axis_size(mesh, table_axis)
    plan: dict[str, tuple[int, int]] = {}
    if n_shards <= 1:
        return plan

    def walk(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if (k in table_keys and isinstance(v, torch.Tensor)
                        and v.dim() == 2 and v.shape[0] % n_shards):
                    rows = v.shape[0]
                    plan[k] = (rows, -(-rows // n_shards) * n_shards)
                else:
                    walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(params)
    return plan


def _map_tables(tree, plan: dict, fn):
    """Apply fn(tensor, logical, padded) to every planned table leaf."""
    if isinstance(tree, dict):
        return {k: (fn(v, *plan[k]) if k in plan and isinstance(
                    v, torch.Tensor) and v.dim() == 2
                    else _map_tables(v, plan, fn))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tables(v, plan, fn) for v in tree)
    return tree


def pad_tables(tree, plan: dict):
    """Zero-pad planned tables to their shard-multiple row count (params
    and the optimizer's moments alike)."""
    if not plan:
        return tree
    return _map_tables(
        tree, plan,
        lambda v, lo, hi: torch.cat([v, v.new_zeros((hi - lo, v.shape[1]))])
        if v.shape[0] == lo else v)


def unpad_tables(tree, plan: dict):
    """Logical view of padded tables (a row slice)."""
    if not plan:
        return tree
    return _map_tables(tree, plan,
                       lambda v, lo, hi: v[:lo] if v.shape[0] == hi else v)


def pad_opt_state(opt_state, plan: dict):
    """Pad the param-shaped moment trees of an optimizer state
    (m / v / acc); step counters pass through."""
    if not plan or opt_state is None:
        return opt_state
    return {k: (pad_tables(v, plan) if k in ("m", "v", "acc") else v)
            for k, v in opt_state.items()}


def unpad_opt_state(opt_state, plan: dict):
    """Logical view of a padded optimizer state."""
    if not plan or opt_state is None:
        return opt_state
    return {k: (unpad_tables(v, plan) if k in ("m", "v", "acc") else v)
            for k, v in opt_state.items()}


def _local_blocks(tree, spec, mesh, table_axis):
    def take(v, sharded):
        if not sharded:
            return v
        return v[embedding_sharding(mesh, v.shape[0], table_axis)].clone()
    return tree_unflatten(tree, [take(v, s) for v, s in
                                 zip(tree_leaves(tree), tree_leaves(spec))])


def place_state(params, opt_state, mesh, spec, table_axis: str = "tp"):
    """This rank's part of the (padded) state: its ``table_axis`` row
    block of every row-sharded table and of Adam's m / v / acc; the rest
    (and step counters) whole."""
    params = _local_blocks(params, spec, mesh, table_axis)
    if opt_state is not None:
        opt_state = {k: (_local_blocks(v, spec, mesh, table_axis)
                         if k in ("m", "v", "acc") else v)
                     for k, v in opt_state.items()}
    return params, opt_state


def gather_tables(params, spec, mesh, table_axis: str = "tp"):
    """The whole (padded) tables from every rank's row blocks
    (differentiable: the backward reduce-scatters)."""
    group = axis_group(mesh, table_axis)
    return tree_unflatten(params, [
        all_gather_rows(v, group) if s else v
        for v, s in zip(tree_leaves(params), tree_leaves(spec))])


def place_batch(batch: dict, mesh, axis: str = "dp",
                batch_axis: int = 0) -> dict:
    """This rank's ``axis`` slice of every array's per-step batch axis
    (every rank draws the same global batch, then slices it)."""
    out = {}
    for k, v in batch.items():
        sl = batch_sharding(mesh, v.shape[batch_axis], axis)
        out[k] = v[(slice(None),) * batch_axis + (sl,)]
    return out


def place_epoch_batches(stacked: dict, mesh, axis: str = "dp") -> dict:
    """A whole-epoch (steps, batch, …) stack: the steps whole, each
    step's batch sliced over ``axis``."""
    return place_batch(stacked, mesh, axis, batch_axis=1)


def make_sharded_train_step(model, optimizer, mesh, spec, mode: int = 0,
                            pad_plan: dict | None = None,
                            clip_grad_norm: float | None = None,
                            table_axis: str = "tp"):
    """The step on this rank's state (:func:`place_state`) and batch
    slice (:func:`place_batch`), with ``spec`` from
    :func:`shard_params_spec` of the padded params.  Returns
    step(params, opt_state, consts, extras, batch, rng) → the global
    loss (a detached device scalar); params and opt_state are updated in
    place.  ``clip_grad_norm`` must be the optimizer's: the norm is taken
    over the whole tables before the optimizer's own clip, which then
    finds nothing to cut."""
    plan = pad_plan or {}
    world = math.prod(axis_size(mesh, a) for a in mesh.mesh_dim_names)
    dp_group = axis_group(mesh, "dp")
    tp_group = axis_group(mesh, table_axis)
    flags = tree_leaves(spec)

    def reduce_grads(grads):
        for g, sharded in zip(grads, flags):
            for a in mesh.mesh_dim_names:
                if not (sharded and a == table_axis):
                    all_reduce_(g, axis_group(mesh, a))
        if clip_grad_norm and any(flags):
            zero = grads[0].new_zeros(())
            sq_rows = sum(((g * g).sum() for g, s in zip(grads, flags) if s),
                          zero)
            sq_rep = sum(((g * g).sum() for g, s in zip(grads, flags)
                          if not s), zero)
            gnorm = torch.sqrt(all_reduce_(sq_rows, tp_group) + sq_rep)
            scale = torch.clamp(clip_grad_norm / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            grads = [g * scale for g in grads]
        return grads

    def step(params, opt_state, consts, extras, batch, rng):
        leaves = tree_leaves(params)
        full = gather_tables(params, spec, mesh, table_axis)
        with batch_reduction(dp_group):
            loss, _aux = model.calculate_loss(unpad_tables(full, plan),
                                              consts, extras, batch, rng,
                                              mode=mode)
        grads = torch.autograd.grad(loss, leaves,
                                    grad_outputs=torch.full_like(
                                        loss, 1.0 / world),
                                    allow_unused=True)
        grads = reduce_grads([torch.zeros_like(p) if g is None else g
                              for p, g in zip(leaves, grads)])
        optimizer.update(tree_unflatten(params, grads), opt_state, params)
        return loss.detach()

    return step


def logical_state(params, opt_state, spec, mesh, plan: dict,
                  table_axis: str = "tp"):
    """The whole, unpadded params and optimizer state (no gradient):
    what the evaluator scores and the checkpoint holds."""
    with torch.no_grad():
        params = unpad_tables(gather_tables(params, spec, mesh, table_axis),
                              plan)
        if opt_state is not None:
            opt_state = unpad_opt_state(
                {k: (gather_tables(v, spec, mesh, table_axis)
                     if k in ("m", "v", "acc") else v)
                 for k, v in opt_state.items()}, plan)
    return tree_map(torch.Tensor.detach, params), opt_state

