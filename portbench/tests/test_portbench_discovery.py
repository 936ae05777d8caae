"""The harness finds a configuration, a traffic mix, a metric and a
kernel file that are added under a root by name, with no edit of any
file that is there."""

from __future__ import annotations

import copy
import json
import os
import shutil
import time

import torch

from conftest import ROOT, tiny
from portbench import harness
from portbench import run as runner

KINDS = ("configs", "traffic", "limits", "metrics", "kernels", "reference",
         "runners", "frozen")


def copy_root(tmp_path) -> str:
    base = tmp_path / "pb"
    for kind in KINDS:
        shutil.copytree(os.path.join(ROOT, "portbench", kind), base / kind)
    return str(base)


def test_added_files_are_found_by_name(tmp_path, bench):
    base = copy_root(tmp_path)
    cfg = harness.load_json("configs", "lightgcn-gowalla", base)
    cfg["data"]["shape"] = tiny("lightgcn-gowalla")["data"]["shape"]
    cfg["port"].update(train_batch_size=256, n_layers=2,
                       sparse_spmm_impl="ell")
    with open(os.path.join(base, "configs", "lgcn-two-layers.json"), "w",
              encoding="utf-8") as f:
        json.dump(cfg, f)
    mix = harness.load_json("traffic", "fit", base)
    mix["first_steps"] = 2
    with open(os.path.join(base, "traffic", "fit-two.json"), "w",
              encoding="utf-8") as f:
        json.dump(mix, f)
    shutil.copy(os.path.join(base, "limits", "lightgcn-gowalla.train.json"),
                os.path.join(base, "limits", "lgcn-two-layers.fit-two.json"))
    with open(os.path.join(base, "metrics", "steps_seen.train.py"), "w",
              encoding="utf-8") as f:
        f.write("def read(rec):\n    return rec.work.get('steps')\n")
    with open(os.path.join(base, "kernels", "other.json"), "w",
              encoding="utf-8") as f:
        json.dump({"spmm": {"per_call": "k_a", "kernels": ["k_a"]}}, f)

    b = copy.deepcopy(bench)
    b["configs"].append({"name": "lgcn-two-layers", "source": "x",
                         "file": "portbench/configs/lgcn-two-layers.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "lgcn-two-layers.fit-two",
                           "config": "lgcn-two-layers", "traffic": "fit-two",
                           "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "train/trainer step",
                           "moves": "train_samples_per_s",
                           "workloads": ["lgcn-two-layers.fit-two"]})
    res = runner.run_cell(b, "lgcn-two-layers.fit-two", 7, 1.0, True,
                          torch.device("cpu"), time.perf_counter(), base,
                          overrides={"mix": {"trace_at": 0.2,
                                             "trace_s": 0.2}})
    assert res["correct"], res["checks"]
    assert "steps_seen.train" in res["cpu_dry_run"]["readers"]
    assert harness.load_json("kernels", "other", base)["spmm"]["per_call"] \
        == "k_a"
