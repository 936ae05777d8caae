"""Config system: layered yaml cascade + model/dataset resolution.

Port of ``recbole_gnn_tpu/config/config.py``, with the same merge
order, lowest priority first:

  1. framework defaults          (config/properties/base/overall.yaml)
  2. model defaults              (config/properties/model/<Model>.yaml)
  3. per-type base               (sequential_base.yaml / social_base.yaml)
  4. user config files           (config_file_list)
  5. explicit dict               (config_dict)
  6. CLI ``--key=value`` args    (parse_cli)

Values are yaml-parsed everywhere so `'1e-3'`, `'[10, 20]'`, `'~'`
behave identically from any layer.  The yaml files are byte-for-byte
copies of the JAX package's.
"""

from __future__ import annotations

import os
import sys

import yaml

from recbole_gnn_tpu_torch.models import model_info
from recbole_gnn_tpu_torch.utils.enums import ModelType

_PROPERTIES_DIR = os.path.join(os.path.dirname(__file__), "properties")


def _load_yaml(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f) or {}


def _coerce(value):
    """Parse a string value as yaml (numbers, lists, dicts, null…).

    YAML 1.1 leaves '1e-05'-style floats as strings (no dot before the
    exponent); a numeric fallback catches those."""
    if not isinstance(value, str):
        return value
    try:
        value = yaml.safe_load(value)
    except yaml.YAMLError:
        return value
    if isinstance(value, str):
        try:
            return int(value)
        except ValueError:
            pass
        try:
            return float(value)
        except ValueError:
            pass
    return value


class Config:
    """Dict-like; missing keys read as None (matching the reference's
    tolerant `config['key']` accesses)."""

    def __init__(self, model: str | None = None, dataset: str | None = None,
                 config_file_list: list[str] | None = None,
                 config_dict: dict | None = None):
        self._data: dict = {}
        self._merge(_load_yaml(os.path.join(_PROPERTIES_DIR, "base", "overall.yaml")))

        # resolve model/dataset names (dict/files can also carry them,
        # mirroring [recbole] `_get_model_and_dataset`)
        file_dicts = [_load_yaml(f) for f in (config_file_list or [])]
        cd = dict(config_dict or {})
        model = model or cd.get("model") or next(
            (d["model"] for d in file_dicts if "model" in d), None)
        dataset = dataset or cd.get("dataset") or next(
            (d["dataset"] for d in file_dicts if "dataset" in d), None)
        if model is None:
            raise ValueError("model name must be given (arg, dict or file)")
        if dataset is None:
            raise ValueError("dataset name must be given (arg, dict or file)")

        info = model_info(model)
        self.model_name = model
        self.dataset_name = dataset

        model_yaml = os.path.join(_PROPERTIES_DIR, "model", f"{model}.yaml")
        if os.path.isfile(model_yaml):
            self._merge(_load_yaml(model_yaml))
        if info.model_type == ModelType.SEQUENTIAL:
            self._merge(_load_yaml(
                os.path.join(_PROPERTIES_DIR, "base", "sequential_base.yaml")))
        elif info.model_type == ModelType.SOCIAL:
            self._merge(_load_yaml(
                os.path.join(_PROPERTIES_DIR, "base", "social_base.yaml")))

        for d in file_dicts:
            self._merge(d)
        self._merge(cd)

        self._data["model"] = model
        self._data["dataset"] = dataset
        self._data["MODEL_TYPE"] = info.model_type
        self._post_process()

    # -- merging -------------------------------------------------------

    def _merge(self, other: dict):
        for k, v in (other or {}).items():
            self._data[k] = _coerce(v)

    def _post_process(self):
        # normalize eval_args: partial overrides keep missing sub-keys
        ea = dict(self._data.get("eval_args") or {})
        defaults = {"split": {"RS": [0.8, 0.1, 0.1]}, "group_by": "user",
                    "order": "RO", "mode": "full"}
        for k, v in defaults.items():
            ea.setdefault(k, v)
        self._data["eval_args"] = ea
        topk = self._data.get("topk") or [10]
        if isinstance(topk, int):
            topk = [topk]
        self._data["topk"] = [int(k) for k in topk]
        vm = self._data.get("valid_metric") or "MRR@10"
        self._data["valid_metric"] = vm
        es = self._data.get("enable_sparse")
        if es not in (True, False, None):
            raise ValueError(
                f"enable_sparse must be True/False/None, got {es!r}")

    # -- mapping interface ---------------------------------------------

    def __getitem__(self, key):
        return self._data.get(key)

    def get(self, key, default=None):
        v = self._data.get(key)
        return default if v is None else v

    def or_default(self, key, default):
        """The value of ``key``, or ``default`` where it is missing,
        empty or zero: the JAX package's read of the keys whose falsy
        value means "use the default" (``metrics``, ``learning_rate``,
        ``valid_metric``, ``learner``, ``eval_step``, and the models'
        list and string settings such as ``hidden_size_list``,
        ``gate_layer_ids`` or SGL's ``type``); :meth:`get` keeps a falsy
        value."""
        return self._data.get(key) or default

    def __setitem__(self, key, value):
        self._data[key] = _coerce(value)

    def __contains__(self, key):
        return key in self._data

    def keys(self):
        return self._data.keys()

    def as_dict(self) -> dict:
        return dict(self._data)

    def __str__(self):
        lines = [f"  {k} = {v}" for k, v in sorted(
            self._data.items(), key=lambda kv: str(kv[0]))]
        return "Config(\n" + "\n".join(lines) + "\n)"


def parse_cli(argv: list[str] | None = None) -> dict:
    """Collect ``--key=value`` pairs from argv into a config dict."""
    argv = sys.argv[1:] if argv is None else argv
    out = {}
    for arg in argv:
        if arg.startswith("--") and "=" in arg:
            k, v = arg[2:].split("=", 1)
            out[k] = _coerce(v)
    return out
