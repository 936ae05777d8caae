"""Port parity: hyper-tuning.

With a stub objective (a fixed function of the parameter set), the
port's ``HyperTuning`` evaluates the same parameter sets in the same
order as the JAX package's for ``exhaustive``, ``random`` and ``bayes``
(the search's randomness is numpy ``default_rng(seed)`` in both), and
picks the same best set.  One real ``objective_function`` run on the
fixture (LightGCN, 1 epoch) writes a result file of the JAX package's
format, and ``python -m recbole_gnn_tpu_torch.run_hyper`` runs from the
CLI."""

import ast
import os
import re
import subprocess
import sys

import pytest
import yaml

from conftest import base_config_dict
from recbole_gnn_tpu.hyper import HyperTuning as JHyper
from recbole_gnn_tpu.hyper import parse_params_file as j_parse
from recbole_gnn_tpu_torch.hyper import HyperTuning as THyper
from recbole_gnn_tpu_torch.hyper import parse_params_file as t_parse
from torch_parity_utils import jax_globals

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPACE = """# a mixed space
learning_rate loguniform [1e-4, 1e-2]
n_layers choice [1, 2, 3]
reg_weight uniform 0.0, 0.5
embedding_size choice [8, 16]
"""


def stub(calls):
    def objective(config_dict=None, config_file_list=None, saved=True):
        calls.append(dict(config_dict))
        score = (config_dict["n_layers"] * 0.1
                 + config_dict["embedding_size"] * 0.01
                 - abs(config_dict["reg_weight"] - 0.2)
                 + 0.05 * float(config_dict["learning_rate"] > 1e-3))
        return {"best_valid_score": score, "valid_score_bigger": True,
                "best_valid_result": {"mrr@10": score},
                "test_result": {"mrr@10": score}}
    return objective


@pytest.mark.parametrize("algo", ["exhaustive", "random", "bayes"])
def test_searches_draw_the_same_sets_as_jax(tmp_path, algo):
    params = tmp_path / "space.params"
    params.write_text(SPACE)
    assert t_parse(str(params)) == j_parse(str(params))
    runs = []
    for cls in (JHyper, THyper):
        calls = []
        hp = cls(stub(calls), algo=algo, params_file=str(params),
                 fixed_config_dict={"model": "LightGCN"}, max_evals=12,
                 seed=7)
        best, _ = hp.run()
        runs.append((calls, best, hp.params2result))
    (j_calls, j_best, j_res), (t_calls, t_best, t_res) = runs
    assert len(t_calls) == (5 * 3 * 5 * 2 if algo == "exhaustive" else 12)
    assert t_calls == j_calls and t_best == j_best
    assert list(t_res) == list(j_res)
    assert all(c["model"] == "LightGCN" for c in t_calls)


def _result_blocks(path):
    """[(params dict, valid keys, test keys)] of an exported file."""
    text = open(path).read()
    out = []
    for block in text.strip().split("\n\n"):
        lines = block.splitlines()
        assert lines[1] == "Valid result:" and lines[3] == "Test result:"
        keys = [sorted(re.findall(r"'([a-z]+@\d+)'", lines[i]))
                for i in (2, 4)]
        out.append((ast.literal_eval(lines[0]), *keys))
    return out


def test_objective_run_exports_the_jax_format(monkeypatch, tmp_path):
    jax_globals(monkeypatch)
    space = {"learning_rate": [0.01], "n_layers": [1]}
    files = []
    for name, cls in (("jax", JHyper), ("torch", THyper)):
        cd = base_config_dict(model="LightGCN", use_gpu=False,
                              embedding_size=16,
                              checkpoint_dir=str(tmp_path / name))
        hp = cls(space=space, fixed_config_dict=cd)
        best, result = hp.run()
        assert best == {"learning_rate": 0.01, "n_layers": 1}
        assert 0 <= result["test_result"]["recall@10"] <= 1
        out = tmp_path / f"{name}.txt"
        hp.export_result(str(out))
        files.append(_result_blocks(out))
    assert files[0] == files[1] and len(files[1]) == 1


def test_run_hyper_cli(tmp_path):
    cfg = base_config_dict(model="LightGCN", use_gpu=False,
                           embedding_size=16,
                           checkpoint_dir=str(tmp_path / "saved"))
    cfg_file = tmp_path / "run.yaml"
    cfg_file.write_text(yaml.safe_dump(cfg))
    params = tmp_path / "space.params"
    params.write_text("n_layers choice [1, 2]\n")
    out = tmp_path / "result.txt"
    r = subprocess.run(
        [sys.executable, "-m", "recbole_gnn_tpu_torch.run_hyper",
         f"--config_files={cfg_file}", f"--params_file={params}",
         f"--output_file={out}", "--algo=random", "--max_evals=2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "best params:" in r.stdout
    blocks = _result_blocks(out)
    assert sorted(b[0]["n_layers"] for b in blocks) == [1, 2]
