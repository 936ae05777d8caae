"""The port's span store (``recbole_gnn_tpu_torch/utils/trace.py``), the
spans and counters at the training path's layer boundaries, and the
benchmark's six readers of them.

* A span records under its path with its count, total and self time,
  closes on an exception, and keeps one stack per thread.
* Spans opened under a ``torch.profiler`` session go to their own
  bucket and enter a host range ``"rgt/" + path``, nested as the spans
  are; outside a session none is entered.
* The sampler's ``checked`` / ``bitset_tests`` / ``drawn`` equal a
  hand count.
* A CPU ``fit`` puts its spans under ``fit/epoch/...`` and writes each
  epoch's spans into its ``train_epoch`` event.
* The readers of ``forward_ms.train`` … ``sample_checks_per_negative.train``
  read finite values after a tiny CPU run of ``lightgcn-gowalla.train``,
  and None where no ``fit`` path was recorded.
"""

import importlib.util
import json
import math
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from conftest import base_config_dict
from portbench import harness
from portbench import run as bench_run
from recbole_gnn_tpu_torch.config import Config
from recbole_gnn_tpu_torch.data.sampler import UniformNegativeSampler
from recbole_gnn_tpu_torch.models import get_model
from recbole_gnn_tpu_torch.quick_start import create_dataset, data_preparation
from recbole_gnn_tpu_torch.train.trainer import Trainer
from recbole_gnn_tpu_torch.utils import trace
from recbole_gnn_tpu_torch.utils.trace import PREFIX, SpanStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
           "to_device_ms.train", "sample_ms.train",
           "sample_checks_per_negative.train")


def _bench_tiny():
    """``portbench/tests/conftest.py``'s ``tiny`` (loaded by path: this
    directory's own ``conftest`` holds the name)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_tests_conftest",
        os.path.join(ROOT, "portbench", "tests", "conftest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.tiny


def test_nesting_paths_and_self_time():
    st = SpanStore()
    with st.span("a") as a:
        with st.span("b") as b1:
            with st.span("c") as c:
                time.sleep(0.001)
        with st.span("b") as b2:
            st.count("hits", 2)
            st.count("hits", 3)
    with st.span("b") as top:
        pass
    st.count("loose", 1)
    aggs = st.snapshot()["unprofiled"]
    assert set(aggs) == {"a", "a/b", "a/b/c", "b", ""}
    assert aggs["a/b"]["count"] == 2
    assert aggs["a/b"]["total_ns"] == b1.ns + b2.ns
    assert aggs["a/b"]["durations_ns"] == [b1.ns, b2.ns]
    assert aggs["a/b"]["self_ns"] == b1.ns - c.ns + b2.ns
    assert aggs["a"]["self_ns"] == a.ns - b1.ns - b2.ns
    assert aggs["a/b/c"]["self_ns"] == c.ns >= 1_000_000
    assert a.ns >= b1.ns + b2.ns and a.seconds == a.ns * 1e-9
    assert aggs["a/b"]["counters"] == {"hits": 5}
    assert aggs["b"]["count"] == 1 and aggs["b"]["total_ns"] == top.ns
    assert aggs[""]["counters"] == {"loose": 1} and aggs[""]["count"] == 0
    assert st.snapshot()["profiled"] == {}
    assert st.totals()["a/b"] == (2, b1.ns + b2.ns)
    mark = st.totals()
    with st.span("a"):
        with st.span("b") as b3:
            pass
    since = st.since(mark)
    assert set(since) == {"a", "a/b"}
    assert since["a/b"] == [1, b3.ns * 1e-6]
    st.reset()
    assert st.snapshot() == {"unprofiled": {}, "profiled": {}}


def test_span_closes_on_an_exception():
    st = SpanStore()
    with pytest.raises(KeyError):
        with st.span("outer"):
            with st.span("inner"):
                raise KeyError("x")
    aggs = st.snapshot()["unprofiled"]
    assert aggs["outer"]["count"] == aggs["outer/inner"]["count"] == 1
    assert st._stack() == []
    with st.span("after"):
        pass
    assert "after" in st.snapshot()["unprofiled"]


def test_each_thread_keeps_its_own_stack():
    st = SpanStore()
    opened, done = threading.Event(), threading.Event()

    def holder():
        with st.span("a"):
            opened.set()
            assert done.wait(10)

    t = threading.Thread(target=holder)
    t.start()
    assert opened.wait(10)
    with st.span("b"):
        with st.span("c"):
            pass
    done.set()
    t.join(10)
    assert not t.is_alive()
    assert set(st.snapshot()["unprofiled"]) == {"a", "b", "b/c"}


def test_no_update_is_lost_across_threads():
    st = SpanStore()
    n_threads, n_spans = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with st.span("w"):
                    st.count("n", 1)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    agg = st.snapshot()["unprofiled"]["w"]
    assert agg["count"] == len(agg["durations_ns"]) == n_threads * n_spans
    assert agg["counters"] == {"n": n_threads * n_spans}


def test_profiled_spans_are_ranges_in_their_own_bucket(monkeypatch):
    entered = []
    real = trace._range

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(trace, "_range", counting)
    st = SpanStore()
    with st.span("fit"):
        with st.span("step"):
            pass
    assert entered == []                    # no profiler: no range
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with st.span("fit"):
            with st.span("step"):
                with st.span("forward"):
                    torch.ones(4).add_(1)
                st.count("seen", 1)
    with st.span("fit"):
        pass
    assert entered == [PREFIX + "fit", PREFIX + "fit/step",
                       PREFIX + "fit/step/forward"]
    snap = st.snapshot()
    assert snap["unprofiled"]["fit"]["count"] == 2
    assert snap["unprofiled"]["fit/step"]["count"] == 1
    assert snap["profiled"]["fit"]["count"] == 1
    assert snap["profiled"]["fit/step/forward"]["count"] == 1
    assert snap["profiled"]["fit/step"]["counters"] == {"seen": 1}
    assert "counters" in snap["unprofiled"]["fit/step"]
    assert snap["unprofiled"]["fit/step"]["counters"] == {}
    ranges = {e.name: e for e in prof.events()
              if e.name.startswith(PREFIX)}
    assert set(ranges) == {PREFIX + "fit", PREFIX + "fit/step",
                           PREFIX + "fit/step/forward"}
    assert ranges[PREFIX + "fit"].cpu_parent is None
    assert ranges[PREFIX + "fit/step"].cpu_parent.name == PREFIX + "fit"
    assert ranges[PREFIX + "fit/step/forward"].cpu_parent.name == \
        PREFIX + "fit/step"
    assert any(c.name.startswith("aten::")
               for c in ranges[PREFIX + "fit/step/forward"].cpu_children)
    # host ranges, not user annotations (which the profiler would copy
    # onto the device's timeline)
    assert not any(e.is_user_annotation for e in ranges.values())
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for e in ranges.values())


def _hand_count(users, used, n_items, num, seed, max_tries=100):
    """(negatives, pairs tested) of the sampler's rounds, tested with
    Python sets: every pair in the first round, then only the pairs
    drawn again."""
    rng = np.random.default_rng(seed)
    flat = np.repeat(users, num)
    cand = rng.integers(1, n_items, size=len(flat), dtype=np.int64)
    checked = len(cand)
    bad = [j for j in range(len(flat)) if (flat[j], cand[j]) in used]
    tries = 0
    while bad and tries < max_tries:
        cand[bad] = rng.integers(1, n_items, size=len(bad), dtype=np.int64)
        checked += len(bad)
        bad = [j for j in bad if (flat[j], cand[j]) in used]
        tries += 1
    return cand.reshape(len(users), num), checked


def test_sampler_counts_match_a_hand_count(monkeypatch):
    # 4 users over items 1..7; user 0 has used 6 of the 7, so most of
    # its draws collide and are drawn again
    log = [(0, i) for i in range(1, 7)] + [(1, 1), (1, 2), (2, 3), (3, 5)]
    users = np.array([u for u, _ in log], np.int64)
    items = np.array([i for _, i in log], np.int64)
    st = SpanStore()
    monkeypatch.setattr(trace, "span", st.span)
    monkeypatch.setattr(trace, "count", st.count)
    sampler = UniformNegativeSampler(users, items, 4, 8)
    batch = np.array([0, 0, 1, 2, 3, 0], np.int64)
    for seed in (3, 4):
        negs = sampler.sample(batch, 2, np.random.default_rng(seed))
        want, _ = _hand_count(batch, set(log), 8, 2, seed)
        np.testing.assert_array_equal(negs, want)
    checked = sum(_hand_count(batch, set(log), 8, 2, s)[1] for s in (3, 4))
    agg = st.snapshot()["unprofiled"]["sample"]
    assert agg["count"] == 2
    assert agg["counters"] == {"checked": checked, "bitset_tests": checked,
                               "drawn": 2 * 12}
    assert checked > 2 * 12               # collisions forced redraws


def test_fit_spans_land_under_fit_epoch(tmp_path):
    log = tmp_path / "log.jsonl"
    cfg = Config(config_dict=base_config_dict(
        model="LightGCN", embedding_size=8, n_layers=2, epochs=2, seed=7,
        use_gpu=False, checkpoint_dir=str(tmp_path),
        metrics_log_path=str(log)))
    (train, train_ds), (valid, _), _ = data_preparation(
        cfg, create_dataset(cfg))
    trainer = Trainer(cfg, get_model(cfg["model"])(cfg, train_ds,
                                                   torch.device("cpu")))
    trace.reset()
    trainer.fit(train, valid, saved=False, verbose=False)
    aggs = trace.snapshot()["unprofiled"]
    steps = len(train) * 2
    for path, count in (("fit", 1), ("fit/epoch", 2),
                        ("fit/epoch/shuffle", 2), ("fit/epoch/sample", 2),
                        ("fit/epoch/batch", steps),
                        ("fit/epoch/to_device", steps),
                        ("fit/epoch/step", steps),
                        ("fit/epoch/step/forward", steps),
                        ("fit/epoch/step/backward", steps),
                        ("fit/epoch/step/optimizer", steps),
                        ("fit/evaluate", 2), ("fit/evaluate/propagate", 2)):
        assert aggs[path]["count"] == count, path
    sample = aggs["fit/epoch/sample"]["counters"]
    assert sample["drawn"] == 2 * len(train.users)
    assert sample["checked"] >= sample["drawn"]
    events = [json.loads(line) for line in open(log)]
    epochs = [e for e in events if e["event"] == "train_epoch"]
    valids = [e for e in events if e["event"] == "valid"]
    assert len(epochs) == len(valids) == 2
    # each epoch's seconds is its span's; spans since the previous event
    total_ms = aggs["fit/epoch"]["total_ns"] * 1e-6
    assert math.isclose(sum(e["seconds"] for e in epochs) * 1e3, total_ms,
                        rel_tol=1e-9)
    assert math.isclose(sum(e["seconds"] for e in valids) * 1e3,
                        aggs["fit/evaluate"]["total_ns"] * 1e-6,
                        rel_tol=1e-9)
    assert trainer.train_timings == [e["seconds"] for e in epochs]
    for e in epochs:
        assert e["spans"]["fit/epoch"][0] == 1
        assert e["spans"]["fit/epoch/step"][0] == len(train)
        assert e["spans"]["fit/epoch/sample"][0] == 1
        assert math.isclose(e["spans"]["fit/epoch"][1], e["seconds"] * 1e3,
                            rel_tol=1e-9)
        assert e["examples_per_s"] > 0
    assert "fit/evaluate/propagate" not in epochs[0]["spans"]
    assert epochs[1]["spans"]["fit/evaluate/propagate"][0] == 1


@pytest.fixture(scope="module")
def tiny_cell_run():
    """A tiny CPU run of ``lightgcn-gowalla.train`` with the profiler
    late in the window; the store holds that run's spans alone."""
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    cell = "lightgcn-gowalla.train"
    over = _bench_tiny()(cell)
    over["mix"].update(trace_at=0.8, trace_s=0.1)
    trace.reset()
    res = bench_run.run_cell(bench, cell, 2**31 + 11, 1.5, True,
                             torch.device("cpu"), time.perf_counter(),
                             overrides=over)
    values = {n: harness.load_module("metrics", n).read(None)
              for n in READERS}
    return res, values


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_tiny_run(tiny_cell_run, name):
    res, values = tiny_cell_run
    assert res["correct"] is True
    assert name in res["cpu_dry_run"]["readers"]
    assert values[name] is not None and math.isfinite(values[name])
    assert values[name] > 0
    if name == "sample_checks_per_negative.train":
        assert values[name] >= 1.0


def test_readers_find_nothing_without_a_fit_path():
    trace.reset()
    with trace.span("step"):
        with trace.span("forward"):
            pass
    with trace.span("sample"):
        trace.count("checked", 3)
        trace.count("drawn", 1)
    for name in READERS:
        assert harness.load_module("metrics", name).read(None) is None, name
