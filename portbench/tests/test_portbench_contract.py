"""``BENCHMARK.json`` parses, keeps to the benchmark's contract, and
every name in it has its files under ``portbench/``."""

from __future__ import annotations

import os
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert one_line(word) and not word.startswith("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])


def test_run_seconds_fit_the_check_with_24_cells(bench):
    s = bench["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_sources(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith(bench["paths"][0] + "/")
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = []
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert one_line(w["why"])
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"])
                for w in bench["workloads"]}) == len(cells)
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    metric_names = []
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0 < m["bound"] <= 0.25
        metric_names.append(m["name"])
    assert "setup_s" in metric_names
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"])
        assert m["moves"] in e2e
        metric_names.append(m["name"])
    assert len(set(metric_names)) == len(metric_names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(w in cells for w in m.get("workloads", []))


def test_every_cell_reports_setup_another_e2e_and_a_layer(bench):
    for w in bench["workloads"]:
        def has(m):
            return "workloads" not in m or w["name"] in m["workloads"]
        e2e = [m["name"] for m in bench["end_to_end"] if has(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(has(m) for m in bench["per_layer"])


def test_every_name_has_its_files(bench):
    pkg = os.path.join(ROOT, "portbench")
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(pkg, "traffic",
                                           f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(pkg, "limits",
                                           f"{w['name']}.json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(pkg, "metrics",
                                           f"{m['name']}.py"))
