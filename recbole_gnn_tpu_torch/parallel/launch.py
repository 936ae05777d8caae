"""Multi-process launch: the ``torch.distributed`` process group.

Port of ``recbole_gnn_tpu/parallel/launch.py``.  The port runs one
process per rank; each rank holds one device — ``cuda:{LOCAL_RANK}``
on the card (the local rank modulo the visible cards, so ranks that
share one card all take it), the CPU under ``use_gpu: False``.  Every
process calls :func:`init_distributed` before anything touches a
device, which ``run.py --distributed`` does; then ``mesh_shape`` spans
every rank.

    torchrun --nproc_per_node=4 -m recbole_gnn_tpu_torch.run \\
        --distributed -m LightGCN -d gowalla --mesh_shape=[2,2] ...

Without ``torchrun`` pass ``--coordinator_address host:port
--num_processes N --process_id i`` on every process.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from recbole_gnn_tpu_torch.parallel.mesh import make_mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     use_gpu: bool = True) -> int:
    """Initialise the process group; returns this process's rank.

    With ``coordinator_address`` (``host:port``) the group meets at
    ``tcp://{coordinator_address}`` with ``num_processes`` ranks, this
    one ``process_id``.  Without it, ``torchrun``'s ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` are read (the arguments
    given override the last two).  The backend is nccl on the card and
    gloo on the CPU unless ``backend`` names one.  On the card the
    current device is set first, from ``LOCAL_RANK`` (else the rank).
    """
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes "
                             "and --process_id")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    else:
        init_method = "env://"
        world = int(num_processes if num_processes is not None
                    else os.environ["WORLD_SIZE"])
        rank = int(process_id if process_id is not None
                   else os.environ["RANK"])
    if use_gpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass --use_gpu=False (config "
                "use_gpu: False) to run the ranks on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend or ("nccl" if use_gpu else "gloo"),
                            init_method=init_method, world_size=world,
                            rank=rank)
    return dist.get_rank()


def global_mesh(mesh_shape: dict | list | None = None):
    """The mesh over every rank of the initialised group."""
    return make_mesh(mesh_shape)
