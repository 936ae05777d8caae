"""Model registry — name → (module, class, type, dataset class).

Port of ``recbole_gnn_tpu/models/__init__.py``.  The table lists every
model of the JAX package, because ``Config`` needs ``model_info`` for
each of them; ``get_model`` returns only the models ported so far and
names the ROADMAP item that ports each of the others.
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
    # None once ported; else the ROADMAP item that ports it
    pending: str | None = None


_G = ModelType.GENERAL
_S = ModelType.SEQUENTIAL
_SO = ModelType.SOCIAL

_GENERAL_PLAIN = "ROADMAP §1 Slice B item 3 (general models without new ops)"
_GENERAL_OPS = "ROADMAP §1 Slice B item 4 (general models with extra ops)"
_SESSION = "ROADMAP §1 Slice C items 5-6 (session data and models)"
_SOCIAL = "ROADMAP §1 Slice D item 7 (social models)"

_REGISTRY: dict[str, ModelInfo] = {}


def _reg(name, module, class_name, mtype, dataset_class, pending=None):
    _REGISTRY[name.lower()] = ModelInfo(name, module, class_name, mtype,
                                        dataset_class, pending)


# -- general graph recommenders ----------------------------------------
_reg("LightGCN", "general.lightgcn", "LightGCN", _G, "GeneralGraphDataset")
_reg("NGCF", "general.ngcf", "NGCF", _G, "GeneralGraphDataset", _GENERAL_PLAIN)
_reg("SGL", "general.sgl", "SGL", _G, "GeneralGraphDataset", _GENERAL_OPS)
_reg("SimGCL", "general.simgcl", "SimGCL", _G, "GeneralGraphDataset",
     _GENERAL_PLAIN)
_reg("XSimGCL", "general.xsimgcl", "XSimGCL", _G, "GeneralGraphDataset",
     _GENERAL_PLAIN)
_reg("NCL", "general.ncl", "NCL", _G, "GeneralGraphDataset", _GENERAL_OPS)
_reg("HMLET", "general.hmlet", "HMLET", _G, "GeneralGraphDataset",
     _GENERAL_OPS)
_reg("DirectAU", "general.directau", "DirectAU", _G, "GeneralGraphDataset",
     _GENERAL_PLAIN)
_reg("LightGCL", "general.lightgcl", "LightGCL", _G, "GeneralGraphDataset",
     _GENERAL_OPS)
_reg("SSL4REC", "general.ssl4rec", "SSL4REC", _G, "GeneralGraphDataset",
     _GENERAL_PLAIN)

# -- sequential session-graph recommenders -----------------------------
_reg("SRGNN", "sequential.srgnn", "SRGNN", _S, "SessionGraphDataset", _SESSION)
_reg("GCSAN", "sequential.gcsan", "GCSAN", _S, "SessionGraphDataset", _SESSION)
_reg("NISER", "sequential.niser", "NISER", _S, "SessionGraphDataset", _SESSION)
_reg("TAGNN", "sequential.tagnn", "TAGNN", _S, "SessionGraphDataset", _SESSION)
_reg("SGNNHN", "sequential.sgnnhn", "SGNNHN", _S, "SessionGraphDataset",
     _SESSION)
_reg("GCEGNN", "sequential.gcegnn", "GCEGNN", _S, "GCEGNNDataset", _SESSION)
_reg("LESSR", "sequential.lessr", "LESSR", _S, "LESSRDataset", _SESSION)

# -- social recommenders -----------------------------------------------
_reg("DiffNet", "social.diffnet", "DiffNet", _SO, "SocialDataset", _SOCIAL)
_reg("MHCN", "social.mhcn", "MHCN", _SO, "SocialDataset", _SOCIAL)
_reg("SEPT", "social.sept", "SEPT", _SO, "SocialDataset", _SOCIAL)

# -- RecBole fallback baselines -----------------------------------------
_reg("BPR", "general.bpr", "BPR", _G, "GeneralGraphDataset")
_reg("NeuMF", "general.neumf", "NeuMF", _G, "GeneralGraphDataset",
     _GENERAL_PLAIN)
_reg("GRU4Rec", "sequential.gru4rec", "GRU4Rec", _S, "SequentialDataset",
     _SESSION)
_reg("NARM", "sequential.narm", "NARM", _S, "SequentialDataset", _SESSION)
_reg("SASRec", "sequential.sasrec", "SASRec", _S, "SequentialDataset",
     _SESSION)


def model_info(name: str) -> ModelInfo:
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(
            f"unknown model {name!r}; known: "
            f"{sorted(i.name for i in _REGISTRY.values())}")
    return _REGISTRY[key]


def get_model(name: str):
    info = model_info(name)
    if info.pending:
        raise NotImplementedError(
            f"{info.name} is not ported to recbole_gnn_tpu_torch yet: "
            f"{info.pending}")
    mod = importlib.import_module(
        f"recbole_gnn_tpu_torch.models.{info.module}")
    return getattr(mod, info.class_name)


def get_dataset_class(name: str):
    from recbole_gnn_tpu_torch.data import dataset as dataset_mod
    info = model_info(name)
    cls = getattr(dataset_mod, info.dataset_class, None)
    if cls is None:
        raise NotImplementedError(
            f"{info.dataset_class} (for {info.name}) is not ported to "
            f"recbole_gnn_tpu_torch yet: {info.pending}")
    return cls


def all_model_names() -> list[str]:
    return sorted(i.name for i in _REGISTRY.values())
