"""Atomic-file reader — RecBole's TSV-with-typed-header format.

Port of ``recbole_gnn_tpu/data/atomic.py`` (host-side pandas/numpy,
identical output): files named ``<dataset>.<suffix>`` (suffix ∈
inter/user/item/net/…) whose header row is ``field:type`` pairs,
tab-separated; types are ``token``, ``token_seq``, ``float``,
``float_seq``.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

TOKEN = "token"
TOKEN_SEQ = "token_seq"
FLOAT = "float"
FLOAT_SEQ = "float_seq"

_VALID_TYPES = {TOKEN, TOKEN_SEQ, FLOAT, FLOAT_SEQ}


def read_atomic_file(path: str, field_separator: str = "\t",
                     seq_separator: str = " ",
                     usecols: list[str] | None = None,
                     ) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Read one atomic file.

    Returns (columns, field2type).  token columns stay as numpy object
    (str) arrays until remapping; float columns become float64;
    *_seq columns become object arrays of numpy arrays.
    """
    with open(path, "r", encoding="utf-8") as f:
        header = f.readline().rstrip("\n").split(field_separator)
    field2type: dict[str, str] = {}
    names = []
    for col in header:
        if ":" not in col:
            raise ValueError(f"{path}: header column {col!r} lacks ':type'")
        name, ftype = col.rsplit(":", 1)
        if ftype not in _VALID_TYPES:
            raise ValueError(f"{path}: unknown field type {ftype!r} for {name!r}")
        field2type[name] = ftype
        names.append(name)

    keep = names if usecols is None else [n for n in names if n in usecols]
    df = pd.read_csv(
        path, sep=field_separator, header=0, names=names,
        usecols=keep, dtype=str, keep_default_na=False, na_values=[],
    )
    out: dict[str, np.ndarray] = {}
    for name in keep:
        ftype = field2type[name]
        col = df[name]
        if ftype == TOKEN:
            out[name] = col.to_numpy(dtype=object)
        elif ftype == FLOAT:
            out[name] = pd.to_numeric(col, errors="coerce").to_numpy(dtype=np.float64)
        elif ftype == TOKEN_SEQ:
            out[name] = np.array(
                [np.array(v.split(seq_separator), dtype=object) for v in col],
                dtype=object)
        else:  # FLOAT_SEQ
            out[name] = np.array(
                [np.array(v.split(seq_separator), dtype=np.float64) for v in col],
                dtype=object)
    return out, {n: field2type[n] for n in keep}


def atomic_path(data_path: str, dataset_name: str, suffix: str) -> str:
    return os.path.join(data_path, dataset_name, f"{dataset_name}.{suffix}")
