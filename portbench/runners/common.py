"""Set-up that every runner shares: the configuration's data written from
its frozen generator into a scratch directory under ``$TMPDIR``, the
port's ``Config`` built from the configuration file, the benchmark's
weights checked against the layout the program expects, and the
reference's reading of the data."""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from portbench import harness


class Scratch:
    """A directory under ``$TMPDIR`` for the run's data, checkpoints and
    artifacts, removed with everything in it on exit."""

    def __enter__(self) -> str:
        self.path = tempfile.mkdtemp(prefix="portbench-",
                                     dir=os.environ.get("TMPDIR"))
        return self.path

    def __exit__(self, *exc) -> None:
        shutil.rmtree(self.path, ignore_errors=True)


def write_data(ctx, root: str) -> str:
    """The configuration's log, written by its frozen generator with the
    configuration's own seed (the data set is the configuration's; the
    run's seed orders and weights it)."""
    data = ctx.cfg["data"]
    gen = harness.load_module("frozen", data["module"], ctx.base)
    return getattr(gen, data["writer"])(root, ctx.cfg["dataset"],
                                        int(data["seed"]), **data["shape"])


def port_config(ctx, root: str):
    """The port's ``Config`` for the run: the configuration file's keys,
    the run's seed, the data and checkpoints in ``root``, quiet."""
    from recbole_gnn_tpu_torch.config import Config
    cd = dict(ctx.cfg["port"])
    cd.update(data_path=root, checkpoint_dir=os.path.join(root, "saved"),
              seed=ctx.seed, state="ERROR", show_progress=False,
              use_gpu=ctx.device.type == "cuda")
    return Config(model=ctx.cfg["model"], dataset=ctx.cfg["dataset"],
                  config_dict=cd)


def benchmark_params(ctx, model, shp: dict, seed: int | None = None) -> dict:
    """The benchmark's weights (flat names) made on the device from
    ``seed`` (the run's by default); with ``model``, after checking that
    the program's own initialisation has the same leaves and shapes (a
    server refuses a checkpoint that has not)."""
    gen = torch.Generator(device=ctx.device).manual_seed(
        ctx.seed if seed is None else seed)
    params = ctx.reference.make_params(shp, gen, ctx.device)
    if model is None:
        return params
    want = {k: tuple(v.shape) for k, v in harness.flat(
        model.init_params(torch.Generator().manual_seed(0))).items()}
    got = {k: tuple(v.shape) for k, v in params.items()}
    if got != want:
        raise RuntimeError(f"the program's parameters {want} are not the "
                           f"benchmark's {got}")
    return params


def host(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", torch.float64, copy=True)
            for k, v in tensors.items()}


def draw(seed: int, stream: int) -> np.random.Generator:
    """The run's random stream ``stream`` (arrivals, requests, samples)."""
    return np.random.default_rng((seed, stream))
