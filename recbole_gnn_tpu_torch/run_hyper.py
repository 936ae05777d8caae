"""Hyper-tuning CLI — the port's counterpart of the repo's
``run_hyper.py`` (reference run_hyper.py:6-26), with its arguments.

Usage:
    python -m recbole_gnn_tpu_torch.run_hyper --config_files a.yaml \
        --params_file examples/hyper.params [--output_file out.txt] \
        [--algo exhaustive|random|bayes] [--max_evals 30]

Each evaluation trains on the card unless the config files set
``use_gpu: False``.
"""

from __future__ import annotations

import argparse

from recbole_gnn_tpu_torch.hyper import HyperTuning
from recbole_gnn_tpu_torch.quick_start import objective_function


def main(argv=None):
    parser = argparse.ArgumentParser(prog="recbole_gnn_tpu_torch.run_hyper")
    parser.add_argument("--config_files", type=str, default=None)
    parser.add_argument("--params_file", type=str, required=True)
    parser.add_argument("--output_file", type=str, default="hyper_result.txt")
    parser.add_argument("--algo", type=str, default="exhaustive",
                        choices=["exhaustive", "random", "bayes"])
    parser.add_argument("--max_evals", type=int, default=30,
                        help="evaluation budget for --algo=random/bayes")
    args = parser.parse_args(argv)

    config_file_list = (args.config_files.strip().split(",")
                        if args.config_files else None)
    hp = HyperTuning(objective_function, algo=args.algo,
                     params_file=args.params_file,
                     max_evals=args.max_evals,
                     fixed_config_file_list=config_file_list)
    best_params, best_result = hp.run()
    hp.export_result(args.output_file)
    print("best params: ", best_params)
    print("best result: ", best_result)
    return best_params, best_result


if __name__ == "__main__":
    main()
