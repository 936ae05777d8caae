"""Collectives of the parallel paths, over ``torch.distributed``.

The JAX package runs one program over a mesh and GSPMD inserts its
collectives; the port runs one process per rank and writes them out.
Every helper takes a process group; ``None`` is a group of one (a mesh
of size 1 with no process group), where each collective is the
identity.

Two collectives sit inside autograd, each a ``torch.autograd.Function``
whose backward is the adjoint of its forward:

* :func:`all_gather_rows` concatenates each rank's block of rows; its
  backward sums the cotangents of every rank and keeps this rank's
  block (a reduce-scatter, written as an all-reduce and a slice, which
  gloo supports too);
* :func:`all_reduce_sum` sums a tensor over the group; its backward
  sums the cotangents the same way.

The gloo backend is given host tensors: a CUDA tensor is staged through
host memory when the group's backend is gloo (four ranks that share one
card run their kernels on it and their collectives over gloo).  The
choice reads the backend's name; it never catches an error.

:func:`batch_reduction` names the data-parallel group whose batch sums
the losses of ``models/losses.py`` all-reduce (:func:`batch_sum`) or
whose in-batch rows they gather (:func:`batch_gather`), so every rank
computes the loss of the global batch.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where the group's backend can read it: a host copy of a
    CUDA tensor for gloo, else ``t`` itself (contiguous)."""
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        return t.detach().cpu()
    return t.contiguous()


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group, in place; returns ``t``."""
    if group is None:
        return t
    buf = _staged(t, group)
    dist.all_reduce(buf, group=group)
    if buf is not t:
        t.copy_(buf)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in
    group-rank order.  Not differentiable."""
    if group is None:
        return t
    buf = _staged(t, group)
    parts = [torch.empty_like(buf) for _ in range(group_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def broadcast_object(obj, group, src_group_rank: int = 0):
    """``obj`` of the group's rank ``src_group_rank`` on every rank."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(
        box, src=dist.get_global_rank(group, src_group_rank), group=group)
    return box[0]


class _AllGatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather_cat(x, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        lo = group_rank(ctx.group) * ctx.rows
        return g[lo:lo + ctx.rows], None


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Each rank's (rows, ...) block, concatenated in group-rank order;
    differentiable (backward: the reduce-scatter of the cotangents)."""
    return x if group is None else _AllGatherRows.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the group's ranks; differentiable (backward: Σ of the
    cotangents)."""
    return x if group is None else _AllReduceSum.apply(x, group)


# the data-parallel group the losses reduce their batch over (None: the
# batch is whole on this rank)
_BATCH_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "batch_group", default=None)


@contextlib.contextmanager
def batch_reduction(group):
    """Within the block the losses' batch sums and in-batch rows span
    ``group``'s ranks, each of which holds one slice of the batch."""
    token = _BATCH_GROUP.set(group)
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


def batch_reducing() -> bool:
    """Whether this rank holds a slice of a batch spread over ranks."""
    return _BATCH_GROUP.get() is not None


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """A sum over this rank's batch rows → the sum over the global
    batch."""
    return all_reduce_sum(t, _BATCH_GROUP.get())


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch's entries."""
    group = _BATCH_GROUP.get()
    if group is None:
        return x.mean()
    count = all_reduce_(x.new_tensor(float(x.numel())), group)
    return all_reduce_sum(x.sum(), group) / count


def batch_gather(t: torch.Tensor) -> torch.Tensor:
    """This rank's batch rows → the global batch's rows, in rank order
    (differentiable)."""
    return all_gather_rows(t, _BATCH_GROUP.get())


def batch_gather_ids(t: torch.Tensor) -> torch.Tensor:
    """This rank's batch ids → the global batch's ids (no gradient)."""
    return all_gather_cat(t, _BATCH_GROUP.get())
