"""Shared set-up of the benchmark's CPU tests: tiny sizes of each
configuration, and the ``cuda`` marker of tests that need the card."""

from __future__ import annotations

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# each configuration at a size the CPU runs in seconds: the widths as
# configured, the data and the batches small
TINY = {
    "lightgcn-gowalla": {
        "data": {"shape": {"n_users": 300, "n_items": 500, "n_inter": 6000}},
        "port": {"train_batch_size": 256}},
    "srgnn-diginetica": {
        "data": {"shape": {"n_sessions": 600, "n_items": 200,
                           "n_inter": 5000}},
        "port": {"train_batch_size": 256, "eval_batch_size": 256}},
}
TINY_MIX = {"trace_at": 0.3, "trace_s": 0.3, "rate_per_s": 40,
            "warmup_requests": 5, "check_requests": 16}

# cells whose files are under portbench/ and whose runs were proved
# correct on the card, but whose end-to-end metrics spread too far
# between runs for a bound yet (PERF.md, Open questions), so
# BENCHMARK.json does not list them; the tests drive them all the same
EXTRA_CELLS = [
    {"name": "srgnn-diginetica.train", "config": "srgnn-diginetica",
     "traffic": "fit", "chips": 1, "why": "training"},
    {"name": "lightgcn-gowalla.serve", "config": "lightgcn-gowalla",
     "traffic": "user-topk-poisson", "chips": 1, "why": "serving"},
    {"name": "srgnn-diginetica.serve", "config": "srgnn-diginetica",
     "traffic": "session-topk-poisson", "chips": 1, "why": "serving"},
]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped where there is none")


@pytest.fixture(scope="session")
def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


@pytest.fixture(scope="session")
def bench_all(bench) -> dict:
    """``BENCHMARK.json`` with the cells it does not list yet added."""
    names = {w["name"] for w in bench["workloads"]}
    return dict(bench, workloads=bench["workloads"] + [
        w for w in EXTRA_CELLS if w["name"] not in names])


def tiny(cell: str) -> dict:
    """Overrides that shrink ``cell``'s configuration and traffic."""
    over = {k: dict(v) for k, v in TINY[cell.split(".")[0]].items()}
    over["mix"] = dict(TINY_MIX)
    return over


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
