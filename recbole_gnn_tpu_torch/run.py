"""CLI runner — the port's counterpart of the repo's ``run.py``.

Usage:
    python -m recbole_gnn_tpu_torch.run -m LightGCN -d ml-100k \
        [--config_files a.yaml,b.yaml] [--resume] [--key=value ...]

Runs on the card; ``--use_gpu=False`` runs on the CPU.  Takes the same
flags as ``run.py``; ``--distributed`` (multi-host training) is not
ported yet and raises.
"""

from __future__ import annotations

import argparse

from recbole_gnn_tpu_torch.config.config import parse_cli


def main(argv=None):
    parser = argparse.ArgumentParser(prog="recbole_gnn_tpu_torch.run")
    parser.add_argument("--model", "-m", type=str, default="LightGCN")
    parser.add_argument("--dataset", "-d", type=str, default="ml-100k")
    parser.add_argument("--config_files", type=str, default=None)
    parser.add_argument("--distributed", action="store_true",
                        help="multi-host training (not ported yet)")
    parser.add_argument("--resume", action="store_true",
                        help="continue training from the saved checkpoint "
                             "(params + optimizer + extras at best epoch)")
    parser.add_argument("--coordinator_address", type=str, default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    args, unknown = parser.parse_known_args(argv)
    if args.distributed:
        raise NotImplementedError(
            "--distributed is not ported to recbole_gnn_tpu_torch yet "
            "(ROADMAP §1 Slice E item 9)")

    from recbole_gnn_tpu_torch.quick_start import run_recbole_gnn_tpu

    config_dict = parse_cli(unknown)
    if args.resume:
        config_dict["resume"] = True
    config_file_list = (args.config_files.strip().split(",")
                        if args.config_files else None)
    return run_recbole_gnn_tpu(model=args.model, dataset=args.dataset,
                               config_file_list=config_file_list,
                               config_dict=config_dict)


if __name__ == "__main__":
    main()
