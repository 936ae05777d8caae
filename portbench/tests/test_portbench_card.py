"""Each cell through the whole harness on the card, with a short
window: it runs, reports the card, and comes out correct.  Skipped
where there is no card."""

from __future__ import annotations

import time

import pytest

from portbench import run as runner

CELLS = ("lightgcn-gowalla.train", "srgnn-diginetica.train",
         "lightgcn-gowalla.serve", "srgnn-diginetica.serve")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(bench_all, cell, card):
    res = runner.run_cell(bench_all, cell, 2**31 + 77, 3.0, False, card,
                          time.perf_counter())
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
    assert res["correct"], res["checks"]
    assert "setup_s" in res["metrics"]
