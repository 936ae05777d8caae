"""Quick-start pipeline: config → data → model → train → eval.

Port of ``recbole_gnn_tpu/quick_start.py`` (``create_dataset`` with
its ``save_dataset`` cache, ``data_preparation`` with its
``save_dataloaders`` cache and its general and sequential loaders,
``run_recbole_gnn_tpu``, ``objective_function``) plus
``resolve_device``: entry points run on the card unless
``use_gpu: False`` or ``device="cpu"`` is given.
"""

from __future__ import annotations

import os
import pickle
import time

import torch
import torch.distributed as dist

from recbole_gnn_tpu_torch.config import Config
from recbole_gnn_tpu_torch.data.loader import (
    FullSortEvalLoader, NegSampleEvalLoader, SequentialFullSortEvalLoader,
    SequentialNegSampleEvalLoader, SequentialTrainLoader, TrainLoader)
from recbole_gnn_tpu_torch.models import get_dataset_class, get_model
from recbole_gnn_tpu_torch.ops.spmm import SPMM_IMPLS, SPMM_PRECISIONS
from recbole_gnn_tpu_torch.train.trainer import get_trainer
from recbole_gnn_tpu_torch.utils.enums import ModelType
from recbole_gnn_tpu_torch.utils.logging import init_logger
from recbole_gnn_tpu_torch.utils.seed import init_seed

_DATASET_CACHE_KEYS = (
    "dataset", "data_path", "load_col", "val_interval",
    "user_inter_num_interval", "item_inter_num_interval", "seed",
    "repeatable", "MAX_ITEM_LIST_LENGTH", "filter_net_by_inter",
    "undirected_net",
)

# bump when the pickled dataset/split schema changes (a stale cache
# would feed models arrays they no longer expect)
_DATASET_SCHEMA_VERSION = 2


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


def _cache_key(config) -> dict:
    key = {k: config[k] for k in _DATASET_CACHE_KEYS}
    key["__schema__"] = _DATASET_SCHEMA_VERSION
    return key


def _load_cache(path: str, want_key: dict, field: str):
    """The cached object under ``field`` if ``path`` holds one written
    for ``want_key``, else None.  The cache is a pickle this program
    wrote into ``checkpoint_dir``."""
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        blob = pickle.load(f)
    return blob[field] if blob.get("key") == want_key else None


def _write_cache(path: str, want_key: dict, field: str, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"   # atomic: concurrent runs share it
    with open(tmp, "wb") as f:
        pickle.dump({"key": want_key, field: obj}, f)
    os.replace(tmp, path)


def create_dataset(config):
    """Resolve + build the dataset for config['model'], after checking
    the SpMM config keys as the JAX package does.

    With ``save_dataset`` the processed dataset pickles to
    ``{checkpoint_dir}/{dataset}-{Class}.pth`` and reloads only when
    every cache-relevant config value matches."""
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
    cls = get_dataset_class(config["model"])
    if not config["save_dataset"]:
        return cls(config)
    path = os.path.join(config.get("checkpoint_dir", "saved/"),
                        f"{config['dataset']}-{cls.__name__}.pth")
    want_key = _cache_key(config)
    ds = _load_cache(path, want_key, "dataset")
    if ds is None:
        ds = cls(config)
        ds.config = None          # the config is not part of the cache
        _write_cache(path, want_key, "dataset", ds)
    ds.config = config
    return ds


def _parse_eval_mode(config) -> tuple[str, int]:
    """'full' | 'uniN' | 'popN' → (mode, sample_num)."""
    mode = config.get("eval_args", {}).get("mode") or "full"
    if mode == "full":
        return "full", 0
    if mode.startswith("uni"):
        return "uni", int(mode[3:])
    if mode.startswith("pop"):
        return "pop", int(mode[3:])
    raise ValueError(f"unsupported eval mode {mode!r}")


def data_preparation(config, dataset):
    """Split + wrap in loaders → (train_data, valid_data, test_data),
    each a (loader, split dataset) pair; the model is built on the
    train split.

    With ``save_dataloaders`` the three splits (with their session-graph
    arrays) pickle beside the dataset cache and reload when the cache
    key matches."""
    splits = None
    if config["save_dataloaders"]:
        cache_path = os.path.join(
            config.get("checkpoint_dir", "saved/"),
            f"{config['dataset']}-{type(dataset).__name__}-splits.pth")
        want_key = dict(_cache_key(config), eval_args=config["eval_args"])
        splits = _load_cache(cache_path, want_key, "splits")
        if splits is None:
            splits = dataset.build()
            for s in splits:
                s.config = None
            _write_cache(cache_path, want_key, "splits", tuple(splits))
        for s in splits:
            s.config = config
    train_ds, valid_ds, test_ds = splits or dataset.build()

    mode, sample_num = _parse_eval_mode(config)
    if config["MODEL_TYPE"] == ModelType.SEQUENTIAL:
        train_loader = SequentialTrainLoader(train_ds, config)
        if mode == "full":
            valid_loader = SequentialFullSortEvalLoader(valid_ds, config)
            test_loader = SequentialFullSortEvalLoader(test_ds, config)
        else:
            valid_loader = SequentialNegSampleEvalLoader(
                valid_ds, [train_ds], config, sample_num, distribution=mode)
            test_loader = SequentialNegSampleEvalLoader(
                test_ds, [train_ds, valid_ds], config, sample_num,
                distribution=mode)
        return (train_loader, train_ds), (valid_loader, valid_ds), \
            (test_loader, test_ds)
    train_loader = TrainLoader(train_ds, config)
    if mode == "full":
        valid_loader = FullSortEvalLoader(valid_ds, [train_ds], config)
        test_loader = FullSortEvalLoader(test_ds, [train_ds, valid_ds], config)
    else:
        valid_loader = NegSampleEvalLoader(
            valid_ds, [train_ds], config, sample_num, distribution=mode)
        test_loader = NegSampleEvalLoader(
            test_ds, [train_ds, valid_ds], config, sample_num,
            distribution=mode)
    return (train_loader, train_ds), (valid_loader, valid_ds), \
        (test_loader, test_ds)


def run_recbole_gnn_tpu(model=None, dataset=None, config_file_list=None,
                        config_dict=None, saved=True, verbose=True):
    """End-to-end train + eval; returns the JAX package's dict
    (best_valid_score, valid_score_bigger, best_valid_result,
    test_result)."""
    config = Config(model=model, dataset=dataset,
                    config_file_list=config_file_list,
                    config_dict=config_dict)
    device = resolve_device(config)
    seed = int(config.get("seed", 2020))
    init_seed(seed, bool(config["reproducibility"]))
    logger = init_logger(config)
    # under torch.distributed only rank 0 logs the run; every rank logs
    # its test result
    say = verbose
    verbose = verbose and (not dist.is_initialized() or dist.get_rank() == 0)
    if verbose:
        logger.info(str(config))

    t0 = time.time()
    ds = create_dataset(config)
    if verbose:
        logger.info(str(ds))
        logger.info(f"dataset ready [{time.time() - t0:.1f}s]")
    (train_loader, train_ds), (valid_loader, _), (test_loader, _) = \
        data_preparation(config, ds)
    if verbose:
        logger.info(f"loaders ready [{time.time() - t0:.1f}s]")

    init_seed(seed, bool(config["reproducibility"]))
    model_obj = get_model(config["model"])(config, train_ds, device)
    trainer = get_trainer(config["MODEL_TYPE"], config["model"])(
        config, model_obj)
    if verbose:
        logger.info(f"model + graph consts built [{time.time() - t0:.1f}s]")

    best_valid_score, best_valid_result = trainer.fit(
        train_loader, valid_loader, saved=saved, verbose=verbose,
        resume=bool(config["resume"]))
    test_result = trainer.evaluate(test_loader, load_best_model=saved)
    if verbose:
        logger.info(f"best valid : {best_valid_result}")
    if say:
        logger.info(f"test result: {test_result}")

    return {
        "best_valid_score": best_valid_score,
        "valid_score_bigger": config["valid_metric_bigger"] is not False,
        "best_valid_result": best_valid_result,
        "test_result": test_result,
    }


def objective_function(config_dict=None, config_file_list=None, saved=True):
    """Quiet pipeline for hyper-tuning."""
    config_dict = dict(config_dict or {})
    config_dict.setdefault("state", "ERROR")
    return run_recbole_gnn_tpu(
        config_file_list=config_file_list, config_dict=config_dict,
        saved=saved, verbose=False)
