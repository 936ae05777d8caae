"""CLI runner — the port's counterpart of the repo's ``run.py``.

Usage:
    python -m recbole_gnn_tpu_torch.run -m LightGCN -d ml-100k \
        [--config_files a.yaml,b.yaml] [--resume] [--key=value ...]

Runs on the card; ``--use_gpu=False`` runs on the CPU.  Takes the same
flags as ``run.py``.  ``--distributed`` initialises the
``torch.distributed`` process group before anything touches a device
(``parallel/launch.py``): under ``torchrun`` from its environment, else
from ``--coordinator_address host:port --num_processes N
--process_id i``; ``--mesh_shape`` then spans every rank:

    torchrun --nproc_per_node=4 -m recbole_gnn_tpu_torch.run \
        --distributed -m LightGCN -d ml-100k --mesh_shape=[2,2]
"""

from __future__ import annotations

import argparse

import torch.distributed as dist

from recbole_gnn_tpu_torch.config.config import parse_cli
from recbole_gnn_tpu_torch.parallel.launch import init_distributed


def main(argv=None):
    parser = argparse.ArgumentParser(prog="recbole_gnn_tpu_torch.run")
    parser.add_argument("--model", "-m", type=str, default="LightGCN")
    parser.add_argument("--dataset", "-d", type=str, default="ml-100k")
    parser.add_argument("--config_files", type=str, default=None)
    parser.add_argument("--distributed", action="store_true",
                        help="initialise torch.distributed (one process "
                             "per rank) before any device use")
    parser.add_argument("--resume", action="store_true",
                        help="continue training from the saved checkpoint "
                             "(params + optimizer + extras at best epoch)")
    parser.add_argument("--coordinator_address", type=str, default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    args, unknown = parser.parse_known_args(argv)
    config_dict = parse_cli(unknown)
    if args.distributed:
        # before anything touches a device: each rank takes its own card
        init_distributed(coordinator_address=args.coordinator_address,
                         num_processes=args.num_processes,
                         process_id=args.process_id,
                         use_gpu=config_dict.get("use_gpu") is not False)

    from recbole_gnn_tpu_torch.quick_start import run_recbole_gnn_tpu

    if args.resume:
        config_dict["resume"] = True
    config_file_list = (args.config_files.strip().split(",")
                        if args.config_files else None)
    try:
        return run_recbole_gnn_tpu(model=args.model, dataset=args.dataset,
                                   config_file_list=config_file_list,
                                   config_dict=config_dict)
    finally:
        if args.distributed:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
