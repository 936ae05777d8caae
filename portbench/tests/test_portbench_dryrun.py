"""A run on the CPU reaches its last line and names the CPU as its
device, with no number under a metric's name; the command itself prints
no result without a card, nor in a directory that holds only the
benchmark."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, tiny
from portbench import run as runner


@pytest.mark.parametrize("saved", [False, True])
def test_cpu_dry_run_reports_the_cpu(bench, saved):
    cell = "lightgcn-gowalla.train"
    over = tiny(cell)
    over["mix"]["saved"] = saved          # fit's checkpoint, as a mix sets it
    res = runner.run_cell(bench, cell, 5, 1.0, True, torch.device("cpu"),
                          time.perf_counter(), overrides=over)
    json.dumps(res)                           # one JSON object
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "cpu"
    assert res["metrics"] == {} and "breakdown" not in res
    assert "busy_s" not in res["device"]
    assert res["correct"] is True


def command(cwd) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "lightgcn-gowalla.train", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env, check=False)


def test_no_result_without_a_card():
    out = command(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
