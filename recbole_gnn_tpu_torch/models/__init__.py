"""Model registry — name → (module, class, type, dataset class).

Port of ``recbole_gnn_tpu/models/__init__.py``: every model of the JAX
package.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

from recbole_gnn_tpu_torch.utils.enums import ModelType


@dataclass(frozen=True)
class ModelInfo:
    name: str
    module: str
    class_name: str
    model_type: ModelType
    dataset_class: str   # name in recbole_gnn_tpu_torch.data.dataset


_G = ModelType.GENERAL
_S = ModelType.SEQUENTIAL
_SO = ModelType.SOCIAL

_REGISTRY: dict[str, ModelInfo] = {}


def _reg(name, module, class_name, mtype, dataset_class):
    _REGISTRY[name.lower()] = ModelInfo(name, module, class_name, mtype,
                                        dataset_class)


# -- general graph recommenders ----------------------------------------
_reg("LightGCN", "general.lightgcn", "LightGCN", _G, "GeneralGraphDataset")
_reg("NGCF", "general.ngcf", "NGCF", _G, "GeneralGraphDataset")
_reg("SGL", "general.sgl", "SGL", _G, "GeneralGraphDataset")
_reg("SimGCL", "general.simgcl", "SimGCL", _G, "GeneralGraphDataset")
_reg("XSimGCL", "general.xsimgcl", "XSimGCL", _G, "GeneralGraphDataset")
_reg("NCL", "general.ncl", "NCL", _G, "GeneralGraphDataset")
_reg("HMLET", "general.hmlet", "HMLET", _G, "GeneralGraphDataset")
_reg("DirectAU", "general.directau", "DirectAU", _G, "GeneralGraphDataset")
_reg("LightGCL", "general.lightgcl", "LightGCL", _G, "GeneralGraphDataset")
_reg("SSL4REC", "general.ssl4rec", "SSL4REC", _G, "GeneralGraphDataset")

# -- sequential session-graph recommenders -----------------------------
_reg("SRGNN", "sequential.srgnn", "SRGNN", _S, "SessionGraphDataset")
_reg("GCSAN", "sequential.gcsan", "GCSAN", _S, "SessionGraphDataset")
_reg("NISER", "sequential.niser", "NISER", _S, "SessionGraphDataset")
_reg("TAGNN", "sequential.tagnn", "TAGNN", _S, "SessionGraphDataset")
_reg("SGNNHN", "sequential.sgnnhn", "SGNNHN", _S, "SessionGraphDataset")
_reg("GCEGNN", "sequential.gcegnn", "GCEGNN", _S, "GCEGNNDataset")
_reg("LESSR", "sequential.lessr", "LESSR", _S, "LESSRDataset")

# -- social recommenders -----------------------------------------------
_reg("DiffNet", "social.diffnet", "DiffNet", _SO, "SocialDataset")
_reg("MHCN", "social.mhcn", "MHCN", _SO, "SocialDataset")
_reg("SEPT", "social.sept", "SEPT", _SO, "SocialDataset")

# -- RecBole fallback baselines -----------------------------------------
_reg("BPR", "general.bpr", "BPR", _G, "GeneralGraphDataset")
_reg("NeuMF", "general.neumf", "NeuMF", _G, "GeneralGraphDataset")
_reg("GRU4Rec", "sequential.gru4rec", "GRU4Rec", _S, "SequentialDataset")
_reg("NARM", "sequential.narm", "NARM", _S, "SequentialDataset")
_reg("SASRec", "sequential.sasrec", "SASRec", _S, "SequentialDataset")


def model_info(name: str) -> ModelInfo:
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(
            f"unknown model {name!r}; known: "
            f"{sorted(i.name for i in _REGISTRY.values())}")
    return _REGISTRY[key]


def get_model(name: str):
    info = model_info(name)
    mod = importlib.import_module(
        f"recbole_gnn_tpu_torch.models.{info.module}")
    return getattr(mod, info.class_name)


def get_dataset_class(name: str):
    from recbole_gnn_tpu_torch.data import dataset as dataset_mod
    return getattr(dataset_mod, model_info(name).dataset_class)


def all_model_names() -> list[str]:
    return sorted(i.name for i in _REGISTRY.values())
