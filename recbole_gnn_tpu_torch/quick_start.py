"""Quick-start pieces: device resolution and dataset creation.

Port of the part of ``recbole_gnn_tpu/quick_start.py`` that serving
needs (``create_dataset``; ``use_gpu`` → device).  ``data_preparation``,
the loaders and ``run_recbole_gnn_tpu`` come with the training slice.
"""

from __future__ import annotations

import torch

from recbole_gnn_tpu_torch.models import get_dataset_class
from recbole_gnn_tpu_torch.ops.spmm import SPMM_IMPLS, SPMM_PRECISIONS


def resolve_device(config=None, device: torch.device | str | None = None
                   ) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for the CPU.

    An explicit ``device`` wins; else ``use_gpu: False`` ([recbole]'s
    key) means the CPU and a ``device`` config value other than
    ``auto`` is taken as given; anything else means ``cuda``.  Raises
    ``RuntimeError`` when that is ``cuda`` and no card is present —
    never carries on quietly on the CPU."""
    if device is None and config is not None:
        if config.get("use_gpu") is False:
            device = "cpu"
        elif config.get("device") not in (None, "auto"):
            device = config.get("device")
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --use_gpu=False (config "
            "use_gpu: False, or device='cpu') to run on the CPU")
    return dev


def create_dataset(config):
    """Resolve + build the dataset for config['model'], after checking
    the SpMM config keys as the JAX package does.  (The JAX package's
    pickled dataset cache, ``save_dataset``, is not ported.)"""
    prec = config["pallas_spmm_precision"]
    if prec and str(prec) not in SPMM_PRECISIONS:
        raise ValueError(
            f"pallas_spmm_precision must be packed/f32x2/bf16, "
            f"got {prec!r}")
    impl = config["sparse_spmm_impl"]
    if impl and str(impl) not in SPMM_IMPLS:
        raise ValueError(
            f"sparse_spmm_impl must be 'ell', 'xla' or 'pallas', "
            f"got {impl!r}")
    if config["save_dataset"]:
        raise NotImplementedError(
            "save_dataset (the pickled dataset cache) is not ported to "
            "recbole_gnn_tpu_torch yet (ROADMAP §1 Slice A item 2)")
    return get_dataset_class(config["model"])(config)
