"""Rank mesh and the row blocks each rank owns.

Port of ``recbole_gnn_tpu/parallel/mesh.py``.  The axes are the JAX
package's:

* ``dp`` — the per-step batch is split over it;
* ``tp`` — the user and item tables are split by rows over it (the
  only large tensors; graphs are replicated or edge-sharded).

:func:`make_mesh` arranges the ranks of the initialised process group
(``parallel/launch.py``) as a ``torch.distributed.device_mesh.
DeviceMesh``; with no process group, a mesh of size 1 is a
:class:`LocalMesh`, a group of one.  PyTorch has no sharding objects:
:func:`embedding_sharding`, :func:`batch_sharding` and
:func:`replicated` say which rows or batch entries this rank owns.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from recbole_gnn_tpu_torch.parallel.comm import broadcast_object

AXIS_NAMES = ("dp", "tp", "pp", "sp")


def mesh_axes(mesh_shape: dict | list | tuple | None, n_ranks: int
              ) -> dict[str, int]:
    """{axis: size}: a bare size list (CLI shorthand ``--mesh_shape=[4,2]``)
    takes the names dp, tp, pp, sp in order; None puts all ranks on
    dp."""
    if isinstance(mesh_shape, (list, tuple)):
        if len(mesh_shape) > len(AXIS_NAMES):
            raise ValueError(f"mesh_shape list longer than {len(AXIS_NAMES)} "
                             "axes — use the dict form to name axes")
        mesh_shape = {n: int(s) for n, s in zip(AXIS_NAMES, mesh_shape)}
    if not mesh_shape:
        mesh_shape = {"dp": n_ranks}
    return {str(a): int(s) for a, s in mesh_shape.items()}


class LocalMesh:
    """A mesh of one rank with no process group: every axis has size 1
    and no group, so every collective on it is the identity.  Answers
    the part of ``DeviceMesh``'s interface the port reads."""

    def __init__(self, axes: dict[str, int]):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())
        self.ndim = len(axes)

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def get_group(self, mesh_dim=None):
        return None

    def get_coordinate(self) -> list[int]:
        return [0] * self.ndim


def make_mesh(mesh_shape: dict | list | None = None):
    """A ``DeviceMesh`` over the first n ranks of the process group,
    shaped by ``mesh_shape`` (e.g. ``{'dp': 4, 'tp': 2}``, ``[4, 2]``;
    None → every rank on dp).  The device type follows the group's
    backend (``cuda`` for nccl, ``cpu`` for gloo).  With no process
    group a mesh of size 1 is a :class:`LocalMesh`."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    axes = mesh_axes(mesh_shape, world)
    n = math.prod(axes.values())
    if n > world:
        hint = ("" if dist.is_initialized() else
                " (no process group: launch one process per rank, e.g. "
                "torchrun --nproc_per_node=N ... with --distributed)")
        raise ValueError(f"mesh {axes} needs {n} ranks, the process group "
                         f"has {world}{hint}")
    if not dist.is_initialized():
        return LocalMesh(axes)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n).reshape(tuple(axes.values()))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 when the mesh has no such axis)."""
    names = mesh.mesh_dim_names
    return mesh.shape[names.index(axis)] if axis in names else 1


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 when absent)."""
    if axis not in mesh.mesh_dim_names or axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``; None when
    the mesh has no such axis or no process group."""
    if axis not in mesh.mesh_dim_names:
        return None
    return mesh.get_group(axis)


def in_mesh(mesh) -> bool:
    """Whether this rank is one of the mesh's (the first n of the
    group)."""
    return mesh.get_coordinate() is not None


def is_main(mesh) -> bool:
    """The mesh's rank 0: the one that writes checkpoints and logs."""
    return all(c == 0 for c in (mesh.get_coordinate() or [1]))


def mesh_barrier(mesh) -> None:
    """Wait for every rank of the mesh (a barrier along each axis in
    turn spans the whole mesh)."""
    for axis in mesh.mesh_dim_names:
        group = axis_group(mesh, axis)
        if group is not None:
            dist.barrier(group=group)


def mesh_broadcast(obj, mesh):
    """The mesh rank 0's ``obj`` on every rank of the mesh (a broadcast
    from coordinate 0 along each axis in turn)."""
    for axis in mesh.mesh_dim_names:
        obj = broadcast_object(obj, axis_group(mesh, axis))
    return obj


def _block(n: int, mesh, axis: str) -> slice:
    shards = axis_size(mesh, axis)
    if n % shards:
        raise ValueError(f"{n} rows do not divide over {axis}={shards}")
    per = n // shards
    lo = axis_rank(mesh, axis) * per
    return slice(lo, lo + per)


def embedding_sharding(mesh, n_rows: int, axis: str = "tp") -> slice:
    """The rows of an (n_rows, D) table this rank holds: its block over
    ``axis``, or every row when the mesh has no such axis."""
    return _block(n_rows, mesh, axis)


def batch_sharding(mesh, batch_size: int, axis: str = "dp") -> slice:
    """The entries of a per-step batch this rank takes: its slice over
    ``axis``, or the whole batch when the mesh has no such axis."""
    return _block(batch_size, mesh, axis)


def replicated(mesh, n: int) -> slice:
    """Every entry: a replicated tensor's rows on every rank."""
    return slice(0, n)
