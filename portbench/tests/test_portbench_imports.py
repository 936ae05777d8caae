"""The check for JAX in the process: the top-level name before the first
dot, compared whole; and a CPU run of a cell loads none of it."""

from __future__ import annotations

import os
import subprocess
import sys

from conftest import ROOT
from portbench import harness


def test_rejects_jax_and_the_jax_package():
    assert harness.forbidden_modules(["jax", "os"]) == ["jax"]
    assert harness.forbidden_modules(["jax.numpy"]) == ["jax"]
    assert harness.forbidden_modules(["jaxlib.xla_client"]) == ["jaxlib"]
    assert harness.forbidden_modules(["flax.linen"]) == ["flax"]
    assert harness.forbidden_modules(
        ["recbole_gnn_tpu.models.general"]) == ["recbole_gnn_tpu"]


def test_accepts_the_port():
    assert harness.forbidden_modules(
        ["recbole_gnn_tpu_torch", "recbole_gnn_tpu_torch.ops.spmm",
         "jaxtyping", "torch"]) == []


SCRIPT = r"""
import json, sys, time, torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import EXTRA_CELLS, tiny
from portbench import harness, run
bench = json.load(open({bench!r}))
bench["workloads"] += EXTRA_CELLS
for cell in ("lightgcn-gowalla.serve", "srgnn-diginetica.train"):
    run.run_cell(bench, cell, 3, 0.5, False, torch.device("cpu"),
                 time.perf_counter(), overrides=tiny(cell))
print(json.dumps(harness.forbidden_modules()))
"""


def test_a_cpu_run_loads_no_jax():
    code = SCRIPT.format(root=ROOT, tests=os.path.dirname(__file__),
                         bench=os.path.join(ROOT, "BENCHMARK.json"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
