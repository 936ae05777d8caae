"""Port parity: config cascade, yaml defaults and model registry of
recbole_gnn_tpu_torch against the JAX package."""

import filecmp
import os
import pathlib
import re

import pytest

from conftest import base_config_dict
from recbole_gnn_tpu.config import Config as JConfig
from recbole_gnn_tpu.config.config import parse_cli as j_parse_cli
from recbole_gnn_tpu.models import all_model_names as j_all_models
from recbole_gnn_tpu.models import model_info as j_model_info
from recbole_gnn_tpu_torch.config import Config as TConfig
from recbole_gnn_tpu_torch.config.config import parse_cli as t_parse_cli
from recbole_gnn_tpu_torch.models import all_model_names as t_all_models
from recbole_gnn_tpu_torch.models import get_dataset_class as t_get_dataset_class
from recbole_gnn_tpu_torch.models import get_model as t_get_model
from recbole_gnn_tpu_torch.models import model_info as t_model_info

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _as_plain(cfg) -> dict:
    """Config dict with the package-local ModelType enum as its name."""
    d = cfg.as_dict()
    d["MODEL_TYPE"] = d["MODEL_TYPE"].name
    return d


@pytest.mark.parametrize("model", ["LightGCN", "NGCF", "SRGNN", "DiffNet"])
def test_config_dicts_equal(model):
    cd = base_config_dict(model=model, embedding_size=32, n_layers=3,
                          learning_rate="1e-3", topk=5)
    assert _as_plain(TConfig(config_dict=cd)) == _as_plain(JConfig(config_dict=cd))


def test_config_cli_and_file_overrides_equal(tmp_path):
    f = tmp_path / "over.yaml"
    f.write_text("n_layers: 4\nreg_weight: 1e-4\nenable_sparse: true\n")
    argv = ["--embedding_size=16", "--topk=[5, 20]", "--use_gpu=False",
            "--eval_args={'split': {'LS': 'valid_and_test'}, 'order': 'TO'}",
            "--sparse_spmm_impl=pallas", "positional", "--no_value"]
    assert t_parse_cli(argv) == j_parse_cli(argv)
    cd = dict(base_config_dict(), **t_parse_cli(argv))
    t = TConfig(model="LightGCN", config_file_list=[str(f)], config_dict=cd)
    j = JConfig(model="LightGCN", config_file_list=[str(f)], config_dict=cd)
    assert _as_plain(t) == _as_plain(j)
    assert t["n_layers"] == 4 and t["embedding_size"] == 16
    assert t["eval_args"]["split"] == {"LS": "valid_and_test"}


def test_yaml_trees_byte_identical():
    j = ROOT / "recbole_gnn_tpu" / "config" / "properties"
    t = ROOT / "recbole_gnn_tpu_torch" / "config" / "properties"
    j_files = sorted(p.relative_to(j) for p in j.rglob("*.yaml"))
    t_files = sorted(p.relative_to(t) for p in t.rglob("*.yaml"))
    assert j_files == t_files and j_files
    match, mismatch, errors = filecmp.cmpfiles(
        j, t, [str(p) for p in j_files], shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("bad", ["yes please", 2, "[1]"])
def test_enable_sparse_error_alike(bad):
    cd = base_config_dict(model="LightGCN", enable_sparse=bad)
    with pytest.raises(ValueError) as je:
        JConfig(config_dict=cd)
    with pytest.raises(ValueError) as te:
        TConfig(config_dict=cd)
    assert str(te.value) == str(je.value)


def test_missing_model_or_dataset_error_alike():
    for cd in ({"dataset": "test"}, {"model": "LightGCN"}):
        with pytest.raises(ValueError) as je:
            JConfig(config_dict=cd)
        with pytest.raises(ValueError) as te:
            TConfig(config_dict=cd)
        assert str(te.value) == str(je.value)


def test_registry_tables_equal():
    assert t_all_models() == j_all_models()
    for name in j_all_models():
        j, t = j_model_info(name), t_model_info(name)
        assert (t.name, t.module, t.class_name, t.model_type.name,
                t.dataset_class) == (j.name, j.module, j.class_name,
                                     j.model_type.name, j.dataset_class)


def test_get_model_ported_and_pending():
    """Every registered model is ported: none is pending."""
    assert t_get_model("lightgcn").__name__ == "LightGCN"
    names = t_all_models()
    assert len(names) == 25
    for name in names:
        assert t_get_model(name).__name__ == name
        assert t_get_dataset_class(name).__name__ == \
            t_model_info(name).dataset_class


def test_no_zero_swallowing_config_reads_in_port():
    """Twin of test_models_general's lint for the port: `config[k] or
    default` silently replaces legitimate 0 / 0.0 / False overrides."""
    root = ROOT / "recbole_gnn_tpu_torch"
    pat = re.compile(r'config\[[^\]]+\]\s+or\s')
    allowed = {"state", "checkpoint_dir", "eval_args", "ITEM_ID_FIELD",
               "USER_ID_FIELD", "field_separator", "seq_separator",
               "load_col", "data_path"}
    bad = []
    for p in sorted(root.rglob("*.py")):
        for i, line in enumerate(p.read_text().splitlines(), 1):
            if pat.search(line) and not any(
                    f'"{k}"' in line or f"'{k}'" in line for k in allowed):
                bad.append(f"{p.relative_to(root)}:{i}: {line.strip()}")
    assert not bad, "zero-swallowing config reads:\n" + "\n".join(bad)


def test_port_sources_import_no_jax():
    """Static half of the import check (the subprocess half is in
    test_torch_serve): no port file and no line of chip_smoke.py
    imports jax or the JAX package."""
    pat = re.compile(r'^\s*(import|from)\s+(jax\b|recbole_gnn_tpu(?!_torch)\b)')
    files = sorted((ROOT / "recbole_gnn_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = [f"{p}:{i}" for p in files
           for i, line in enumerate(p.read_text().splitlines(), 1)
           if pat.search(line)]
    assert not bad, bad
    assert os.path.isfile(ROOT / "recbole_gnn_tpu_torch" / "csrc"
                          / "segment_spmm.cu")
