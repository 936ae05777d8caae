"""Port parity across processes: LESSR's masked BatchNorm under data
parallelism.

Two gloo ranks (this file run as a script, ``file://`` rendezvous) each
take their dp slice of one batch and run one step of the port's sharded
trainer (``make_sharded_train_step`` over ``{dp: 2}``, SGD at lr 1, so
the update is the gradient) from one JAX-initialised checkpoint, while
the parent runs the JAX package's step on its 8-device CPU mesh
(``{dp: 2}``: one program over the global batch) and its single-device
gradient.  The BatchNorm statistics of every site (the EOPA / SGAT
layers' masked ones over the valid nodes, ``bn_sr``'s over the w > 0
rows) must be the global batch's: the loss within rtol 1e-5, every
gradient within rtol 1e-4 / atol 1e-6 of JAX's (the fixture's padded
last batch, rows of weight 0 included; dropout off, so both sides draw
nothing).  Taken over each rank's slice, the statistics differ and the
loss moves by far more.
"""

import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RANKS_TIMEOUT = 240
CFG = {"n_layers": 4, "feat_drop": 0.0}


def _rank_main(rank: int, init: str, tmp: str) -> None:
    import torch.distributed as dist
    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    from recbole_gnn_tpu_torch.models import get_model
    from recbole_gnn_tpu_torch.parallel.mesh import make_mesh
    from recbole_gnn_tpu_torch.parallel.sharded_train import (
        logical_state, make_sharded_train_step, place_batch, place_state,
        shard_params_spec)
    from recbole_gnn_tpu_torch.quick_start import (create_dataset,
                                                   data_preparation)
    from recbole_gnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                       params_from_numpy)
    from recbole_gnn_tpu_torch.train.optim import make_optimizer, tree_leaves
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=WORLD, rank=rank)
    cd = json.load(open(os.path.join(tmp, "cfg.json")))
    c = Config(config_dict=cd)
    (_, tr), _, _ = data_preparation(c, create_dataset(c))
    model = get_model("LESSR")(c, tr)
    mesh = make_mesh({"dp": WORLD})
    params = params_from_numpy(load_checkpoint(
        os.path.join(tmp, "init.ckpt"))["params"], "cpu")
    opt = make_optimizer("sgd", 1.0)
    spec = shard_params_spec(params, mesh)
    params, state = place_state(params, opt.init(params), mesh, spec)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = dict(np.load(os.path.join(tmp, "batch.npz")))
    step = make_sharded_train_step(model, opt, mesh, spec)
    loss = step(params, state, model.consts, {},
                to_device(place_batch(batch, mesh), "cpu"),
                torch.Generator().manual_seed(0))
    lp, _ = logical_state(params, None, spec, mesh, {})
    out = {"loss": float(loss),
           "params": [p.numpy() for p in tree_leaves(lp)],
           "rows": int(place_batch(batch, mesh)["item_seq"].shape[0])}
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _jax_side(tmp):
    """The JAX step on the {dp: 2} mesh and the single-device gradient,
    from the same checkpoint and batch; and the port's single-process
    loss on the whole batch."""
    import jax
    import jax.numpy as jnp
    from recbole_gnn_tpu.parallel.mesh import make_mesh as j_make_mesh
    from recbole_gnn_tpu.parallel.sharded_train import (
        make_sharded_train_step, place_batch, place_state)
    from recbole_gnn_tpu.train.checkpoint import load_checkpoint
    from recbole_gnn_tpu.train.optim import make_optimizer
    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    from torch_parity_utils import both, jax_globals, port_params
    cd = json.load(open(os.path.join(tmp, "cfg.json")))
    with pytest.MonkeyPatch.context() as mp:
        jax_globals(mp)
        (_, _, jm), (_, _, tm) = both(cd)
        params = jax.tree_util.tree_map(jnp.asarray, load_checkpoint(
            os.path.join(tmp, "init.ckpt"))["params"])
        batch = dict(np.load(os.path.join(tmp, "batch.npz")))
        key = jax.random.PRNGKey(0)

        def loss_fn(p):
            return jm.calculate_loss(p, jm.consts, {}, batch, key)[0]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        mesh = j_make_mesh({"dp": WORLD})
        opt = make_optimizer("sgd", 1.0)
        pp, oo = place_state(params, opt.init(params), mesh)
        p1, _, l1 = make_sharded_train_step(jm, opt, mesh)(
            pp, oo, jm.consts, {}, place_batch(batch, mesh), key)
        t_loss, _ = tm.calculate_loss(port_params(params, grad=False),
                                      tm.consts, {}, to_device(batch, "cpu"),
                                      torch.Generator().manual_seed(0))
    leaves = jax.tree_util.tree_leaves
    return {"loss": float(loss), "grads": [np.asarray(g) for g in
                                           leaves(grads)],
            "mesh_loss": float(l1),
            "mesh_grads": [np.asarray(a) - np.asarray(b) for a, b in
                           zip(leaves(params), leaves(p1))],
            "params": [np.asarray(p) for p in leaves(params)],
            "port_single_loss": float(t_loss)}


def _write_inputs(tmp):
    import jax
    from recbole_gnn_tpu.config import Config as JConfig
    from recbole_gnn_tpu.models import get_model as j_get_model
    from recbole_gnn_tpu.quick_start import (create_dataset,
                                             data_preparation)
    from recbole_gnn_tpu.train.checkpoint import save_checkpoint
    from recbole_gnn_tpu.train.optim import make_optimizer
    from torch_parity_utils import jax_globals, padded_batch, seq_cfg
    cd = seq_cfg("LESSR", checkpoint_dir=tmp, **CFG)
    with open(os.path.join(tmp, "cfg.json"), "w") as f:
        json.dump(cd, f)
    with pytest.MonkeyPatch.context() as mp:
        jax_globals(mp)
        c = JConfig(config_dict=cd)
        (tl, tr), _, _ = data_preparation(c, create_dataset(c))
        params = j_get_model("LESSR")(c, tr).init_params(
            jax.random.PRNGKey(3))
        batch = padded_batch(tl)
    np.savez(os.path.join(tmp, "batch.npz"),
             **{k: np.asarray(v) for k, v in batch.items()})
    save_checkpoint(os.path.join(tmp, "init.ckpt"), {
        "params": params, "opt_state": make_optimizer("sgd", 1.0).init(
            params), "extras": {}, "epoch": np.int64(-1),
        "config": {"model": "LESSR", "dataset": "test"}})
    return batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("lessr_dp"))
    batch = _write_inputs(tmp)
    init = os.path.join(tmp, "rendezvous")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), init, tmp],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    try:
        t0 = time.time()
        ref = _jax_side(tmp)
        logs = [p.communicate(timeout=max(1, RANKS_TIMEOUT
                                          - (time.time() - t0)))[0]
                for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return {"ref": ref, "ranks": ranks, "batch": batch}


def test_lessr_dp_step_matches_the_jax_mesh(runs):
    ref = runs["ref"]
    n = runs["batch"]["item_seq"].shape[0]
    assert (np.asarray(runs["batch"]["weight"]) == 0).any()
    # the JAX mesh step is the single-device step over the global batch
    np.testing.assert_allclose(ref["mesh_loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(ref["port_single_loss"], ref["loss"],
                               rtol=1e-5)
    for got in runs["ranks"]:
        assert got["rows"] == n // WORLD
        np.testing.assert_allclose(got["loss"], ref["mesh_loss"], rtol=1e-5)
        assert len(got["params"]) == len(ref["grads"])
        for i, (p1, p0, g, gm) in enumerate(zip(
                got["params"], ref["params"], ref["grads"],
                ref["mesh_grads"])):
            np.testing.assert_allclose(p0 - p1, g, rtol=1e-4, atol=1e-6,
                                       err_msg=f"leaf {i}")
            np.testing.assert_allclose(p0 - p1, gm, rtol=1e-4, atol=1e-6,
                                       err_msg=f"leaf {i} (mesh)")


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
