"""Port parity across processes: ``recbole_gnn_tpu_torch/parallel/`` on
four gloo ranks against the JAX package on its 8-device CPU mesh.

One module fixture spawns the four ranks once (this file run as a
script, ``file://`` rendezvous); each runs every scenario and pickles
its results, while the parent computes the JAX references.  Scenarios,
with the ports of ``tests/test_parallel.py`` and
``tests/test_serve.py::test_recserver_mesh_*``:

* ``make_mesh`` over the group: shapes, shorthand, the first n ranks;
* the item-sharded top-k (tp = 4) against single-device top-k and JAX's
  ``distributed_full_sort_topk`` — history ids that straddle shard
  boundaries; a padded catalog with huge pad rows — indices exactly;
* the edge-sharded SpMM over dp = 4, forward and gradient, against the
  dense product and JAX's ``sharded_ell_spmm`` (the (53, 53, 400) and
  (37, 29, 250) cases, and hubs split with ``K_CAP`` patched to 8),
  rtol / atol 2e-4;
* one dp × tp = 2 × 2 step from JAX-initialised params against the
  single-process port step and JAX's ``make_sharded_train_step``: loss
  rtol 1e-5, params rtol 1e-4 / atol 1e-5;
* the ``Trainer`` fit (1 epoch from one JAX-initialised checkpoint) on
  the fixture at ``{dp: 2, tp: 2}`` — dense, with the pad plan engaged
  (351 users, 1,005 items); ``graph_edge_sharding`` on ``ell``; a
  replicated ``ell`` graph with ``enable_sparse`` — against the
  single-process port fit and the JAX fit: params rtol 5e-4 / atol
  5e-5, metrics rtol 1e-5; the checkpoint logical, loaded by both
  packages;
* ``Evaluator(mesh=)``: LightGCN item-sharded, SRGNN (sequential: no
  sharded path, as in the JAX ``Evaluator``) against JAX's;
* ``serve query`` and ``http`` with ``--mesh_shape=[4]`` against the
  single-process server and JAX's ``RecServer(mesh_shape=[4])``.
"""

import contextlib
import io
import json
import os
import pickle
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MESH = {"dp": 2, "tp": 2}
SPMM_CASES = ((53, 53, 400, 31, None), (37, 29, 250, 31, None),
              (41, 41, 600, 32, 8))
FIT_GRAPHS = {"dense": {},
              "edge_sharded": {"enable_sparse": True,
                               "sparse_spmm_impl": "ell",
                               "graph_edge_sharding": True},
              "ell": {"enable_sparse": True, "sparse_spmm_impl": "ell"}}
SPMM_TOL = dict(rtol=2e-4, atol=2e-4)
FIT_TOL = dict(rtol=5e-4, atol=5e-5)
RANKS_TIMEOUT = 240


# -- inputs both sides make from a seed -----------------------------------------

def topk_inputs():
    """The JAX tests' two cases: history ids 0..9 straddle the shard
    boundaries of user 0; a catalog of 60 real rows padded with four
    huge rows to 64."""
    rng = np.random.default_rng(0)
    u = rng.normal(size=(16, 8)).astype(np.float32)
    it = rng.normal(size=(64, 8)).astype(np.float32)
    hist = np.full((16, 10), 63, np.int64)
    hist[0] = np.arange(10)
    rng = np.random.default_rng(3)
    pu = rng.normal(size=(4, 8)).astype(np.float32)
    pit = np.concatenate([rng.normal(size=(60, 8)),
                          np.full((4, 8), 100.0)]).astype(np.float32)
    return (u, it, hist), (pu, pit, np.zeros((4, 1), np.int64))


def spmm_inputs(n_dst, n_src, e, seed, hubs):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, e)
    dst = (np.where(rng.random(e) < 0.5, rng.integers(0, 3, e),
                    rng.integers(0, n_dst, e)) if hubs
           else rng.integers(0, n_dst, e))
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n_src, 8)).astype(np.float32)
    cot = rng.normal(size=(n_dst, 8)).astype(np.float32)
    return src, dst, w, x, cot


# -- the rank program ------------------------------------------------------------

def _port_model(cd):
    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.models import get_model
    from recbole_gnn_tpu_torch.quick_start import (create_dataset,
                                                   data_preparation)
    c = Config(config_dict=cd)
    (tl, tr), (vl, _), (te, _) = data_preparation(c, create_dataset(c))
    return c, tl, vl, get_model(cd["model"])(c, tr)


def _np(tree):
    return {k: (_np(v) if isinstance(v, dict) else
                v.detach().cpu().numpy()) for k, v in tree.items()}


def rank_mesh(tmp, cd):
    from recbole_gnn_tpu_torch.parallel.mesh import (axis_rank, in_mesh,
                                                     make_mesh)
    m = make_mesh([2, 2])
    sub = make_mesh([2])
    try:
        make_mesh([4, 2])
        err = None
    except ValueError as e:
        err = str(e)
    return {"shape": m.shape, "names": m.mesh_dim_names,
            "coord": (axis_rank(m, "dp"), axis_rank(m, "tp")),
            "all_dp": make_mesh(None).shape, "sub_in": in_mesh(sub),
            "too_big": err}


def rank_topk(tmp, cd):
    from recbole_gnn_tpu_torch.parallel.mesh import axis_group, make_mesh
    from recbole_gnn_tpu_torch.parallel.topk import (
        distributed_full_sort_topk)
    mesh = make_mesh({"tp": WORLD})
    group = axis_group(mesh, "tp")
    r = torch.distributed.get_rank(group)
    out = []
    for (u, it, hist), n_valid in zip(topk_inputs(), (None, 60)):
        blk = it.shape[0] // WORLD
        v, i = distributed_full_sort_topk(
            torch.from_numpy(u), torch.from_numpy(it[r * blk:(r + 1) * blk]),
            torch.from_numpy(hist), 5, group, n_valid_items=n_valid)
        out.append((v.numpy(), i.numpy()))
    return out


def rank_spmm(tmp, cd):
    import recbole_gnn_tpu_torch.parallel.sharded_spmm as sp
    from recbole_gnn_tpu_torch.parallel.comm import all_reduce_
    from recbole_gnn_tpu_torch.parallel.mesh import axis_group, make_mesh
    group = axis_group(make_mesh({"dp": WORLD}), "dp")
    out = []
    for n_dst, n_src, e, seed, k_cap in SPMM_CASES:
        src, dst, w, x, cot = spmm_inputs(n_dst, n_src, e, seed, k_cap)
        old = sp.K_CAP
        sp.K_CAP = k_cap or old
        try:
            meta = sp.build_sharded_ell(src, dst, w, n_dst, WORLD,
                                        n_src_nodes=n_src, group=group)
        finally:
            sp.K_CAP = old
        xt = torch.from_numpy(x).requires_grad_(True)
        y = sp.sharded_ell_spmm(meta, xt)
        (y * torch.from_numpy(cot)).sum().backward()
        # every rank differentiates the same sum: Σ of the partial dx
        # over the ranks is WORLD times the gradient
        g = all_reduce_(xt.grad.clone(), group) / WORLD
        out.append((y.detach().numpy(), g.numpy(),
                    int(meta.local.fwd.n_multi), meta.local.n_edges))
    return out


def rank_step(tmp, cd):
    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    from recbole_gnn_tpu_torch.parallel.mesh import make_mesh
    from recbole_gnn_tpu_torch.parallel.sharded_train import (
        logical_state, make_sharded_train_step, pad_opt_state, pad_tables,
        place_batch, place_state, shard_params_spec, table_pad_plan)
    from recbole_gnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                       params_from_numpy)
    from recbole_gnn_tpu_torch.train.optim import make_optimizer
    c, tl, _, model = _port_model(cd)
    mesh = make_mesh(MESH)
    opt = make_optimizer("adam", 1e-3)
    params = params_from_numpy(load_checkpoint(
        os.path.join(tmp, "init_lightgcn.ckpt"))["params"], "cpu")
    plan = table_pad_plan(params, mesh)
    params = pad_tables(params, plan)
    state = pad_opt_state(opt.init(params), plan)
    spec = shard_params_spec(params, mesh)
    params, state = place_state(params, state, mesh, spec)
    for p in params.values():
        p.requires_grad_(True)
    step = make_sharded_train_step(model, opt, mesh, spec, pad_plan=plan)
    batch = next(iter(tl))
    loss = step(params, state, model.consts, {},
                to_device(place_batch(batch, mesh), "cpu"), None)
    lp, lo = logical_state(params, state, spec, mesh, plan)
    return {"loss": float(loss), "params": _np(lp), "plan": plan,
            "block_rows": {k: int(v.shape[0]) for k, v in params.items()},
            "m": _np(lo["m"])}


def rank_fits(tmp, cd):
    from recbole_gnn_tpu_torch.train.trainer import Trainer
    out = {}
    for name, over in FIT_GRAPHS.items():
        fcd = dict(cd, mesh_shape=MESH, **over,
                   checkpoint_dir=os.path.join(tmp, f"ck_{name}"))
        c, tl, vl, model = _port_model(fcd)
        tr = Trainer(c, model)
        tr.resume_from_checkpoint(os.path.join(tmp, "init_lightgcn.ckpt"))
        tr.fit(tl, None, saved=name == "dense", verbose=False)
        out[name] = {"params": _np(tr.params), "plan": tr._pad_plan,
                     "graph": type(model.consts["graph"]).__name__,
                     "metrics": tr.evaluate(vl, load_best_model=False),
                     "m": _np(tr.opt_state["m"])}
    return out


def rank_evaluator(tmp, cd):
    from recbole_gnn_tpu_torch.eval.evaluator import Evaluator
    from recbole_gnn_tpu_torch.parallel.mesh import make_mesh
    from recbole_gnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                       params_from_numpy)
    mesh = make_mesh(MESH)
    out = {}
    for name in ("lightgcn", "srgnn"):
        mcd = json.load(open(os.path.join(tmp, f"cfg_{name}.json")))
        c, _, vl, model = _port_model(mcd)
        params = params_from_numpy(load_checkpoint(os.path.join(
            tmp, f"init_{name}.ckpt"))["params"], "cpu")
        ev = Evaluator(c, model, mesh=mesh)
        out[name] = (ev._use_dist_eval("full"), ev.evaluate(params, {}, vl))
    return out


def rank_serve(tmp, cd):
    import recbole_gnn_tpu_torch.serve as serve
    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.parallel.mesh import make_mesh, mesh_barrier
    art = os.path.join(tmp, "lightgcn.npz")
    rank = torch.distributed.get_rank()
    if rank == 0:
        serve.export_artifact(
            Config(config_dict=dict(cd, checkpoint_dir=os.path.join(
                tmp, "ck_dense"))), art, device="cpu")
    mesh_barrier(make_mesh(None))
    srv = serve.RecServer(art, device="cpu", mesh_shape=[WORLD])
    users = [str(t) for t in srv.user_tokens[1:9]]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        serve.main(["query", "--artifact", art, "--users", *users, "-k",
                    "5", "--mesh_shape=[4]", "--use_gpu=False"])
    got = {"query": text.getvalue(), "users": users,
           "block_rows": int(srv.item_table.shape[0]),
           "ids": srv.recommend(users, k=5, return_tokens=False)[0]}
    if rank != 0:
        serve.follow_requests(srv)
        return got
    front = serve.BroadcastRecServer(srv)
    httpd = serve.make_http_server(front, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/recommend",
            data=json.dumps({"users": users[:3], "k": 5}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got["http"] = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        front.close()
        th.join(timeout=30)
    return got


SCENARIOS = (("mesh", rank_mesh), ("topk", rank_topk), ("spmm", rank_spmm),
             ("step", rank_step), ("fits", rank_fits),
             ("evaluator", rank_evaluator), ("serve", rank_serve))


def _rank_main(rank: int, init: str, tmp: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=WORLD, rank=rank)
    cd = json.load(open(os.path.join(tmp, "cfg_lightgcn.json")))
    out = {}
    for name, fn in SCENARIOS:
        t0 = time.time()
        out[name] = fn(tmp, cd)
        out[f"{name}_s"] = time.time() - t0
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# -- the parent: spawn, JAX references, results ------------------------------------

def _jax_refs(tmp, cd):
    """The JAX package's side, computed while the ranks run."""
    import jax
    import jax.numpy as jnp
    from torch_parity_utils import jax_globals
    import recbole_gnn_tpu.parallel.sharded_spmm as j_sp
    from recbole_gnn_tpu.config import Config as JConfig
    from recbole_gnn_tpu.eval.evaluator import Evaluator as JEvaluator
    from recbole_gnn_tpu.models import get_model as j_get_model
    from recbole_gnn_tpu.parallel.mesh import make_mesh as j_make_mesh
    from recbole_gnn_tpu.parallel.sharded_train import (
        make_sharded_train_step, pad_opt_state, pad_tables, place_batch,
        place_state, table_pad_plan, unpad_tables)
    from recbole_gnn_tpu.parallel.topk import distributed_full_sort_topk
    from recbole_gnn_tpu.quick_start import (create_dataset,
                                             data_preparation)
    from recbole_gnn_tpu.train.checkpoint import load_checkpoint
    from recbole_gnn_tpu.train.optim import make_optimizer
    from recbole_gnn_tpu.train.trainer import Trainer as JTrainer

    refs = {"topk": [], "spmm": []}
    tp4 = j_make_mesh({"tp": WORLD})
    for (u, it, hist), n_valid in zip(topk_inputs(), (None, 60)):
        v, i = jax.jit(lambda u_, it_, h_, n=n_valid: distributed_full_sort_topk(
            u_, it_, h_, 5, tp4, axis="tp", n_valid_items=n))(
                jnp.asarray(u), jnp.asarray(it), jnp.asarray(hist, jnp.int32))
        scores = u @ it.T
        for r in range(len(u)):
            scores[r, hist[r]] = -1e30
        if n_valid:
            scores[:, n_valid:] = -1e30
        refs["topk"].append((np.asarray(v), np.asarray(i),
                             np.argsort(-scores, axis=1)[:, :5]))
    dp4 = j_make_mesh({"dp": WORLD, "tp": 2})
    for n_dst, n_src, e, seed, k_cap in SPMM_CASES:
        src, dst, w, x, cot = spmm_inputs(n_dst, n_src, e, seed, k_cap)
        old = j_sp.K_CAP
        j_sp.K_CAP = k_cap or old
        try:
            meta = j_sp.build_sharded_ell(src, dst, w, n_dst, WORLD,
                                          n_src_nodes=n_src)
        finally:
            j_sp.K_CAP = old
        # jitted: an eager shard_map compiles op by op
        out = jax.jit(lambda x_, m=meta: j_sp.sharded_ell_spmm(
            m, x_, dp4, "dp"))(jnp.asarray(x))
        g = jax.jit(jax.grad(lambda x_, m=meta: jnp.sum(j_sp.sharded_ell_spmm(
            m, x_, dp4, "dp") * jnp.asarray(cot))))(jnp.asarray(x))
        dense = np.zeros((n_dst, n_src))
        np.add.at(dense, (dst, src), w)
        refs["spmm"].append((np.asarray(out), np.asarray(g), dense @ x,
                             dense.T @ cot, meta.fwd.n_multi))

    with pytest.MonkeyPatch.context() as mp:
        jax_globals(mp)
        # one step, single device and dp × tp
        c = JConfig(config_dict=cd)
        (tl, tr), (vl, _), _ = data_preparation(c, create_dataset(c))
        model = j_get_model("LightGCN")(c, tr)
        params = load_checkpoint(os.path.join(tmp, "init_lightgcn.ckpt")
                                 )["params"]
        params = jax.tree_util.tree_map(jnp.asarray, params)
        opt = make_optimizer("adam", 1e-3)
        batch = next(iter(tl))

        def step(p, o, b):
            def loss_fn(q):
                return model.calculate_loss(q, model.consts, {}, b,
                                            jax.random.PRNGKey(0))[0]
            loss, grads = jax.value_and_grad(loss_fn)(p)
            p, o = opt.update(grads, o, p)
            return p, o, loss

        p1, _, l1 = jax.jit(step)(params, opt.init(params), batch)
        mesh = j_make_mesh(MESH)
        plan = table_pad_plan(params, mesh)
        pp, oo = place_state(pad_tables(params, plan),
                             pad_opt_state(opt.init(params), plan), mesh)
        p2, _, l2 = make_sharded_train_step(model, opt, mesh, pad_plan=plan)(
            pp, oo, model.consts, {}, place_batch(batch, mesh),
            jax.random.PRNGKey(0))
        refs["step"] = {"single": (float(l1), jax.tree_util.tree_map(
            np.asarray, p1)), "sharded": (float(l2), jax.tree_util.tree_map(
                np.asarray, unpad_tables(p2, plan))), "plan": plan}

        # 1-epoch fits from the init checkpoint (ell serves both sparse
        # port cases: the JAX single-device graph is the same)
        refs["fits"] = {}
        for name in ("dense", "ell"):
            fc = JConfig(config_dict=dict(cd, **FIT_GRAPHS[name]))
            (ftl, ftr), (fvl, _), _ = data_preparation(fc,
                                                       create_dataset(fc))
            t = JTrainer(fc, j_get_model("LightGCN")(fc, ftr))
            t.resume_from_checkpoint(os.path.join(tmp, "init_lightgcn.ckpt"))
            t.fit(ftl, None, saved=False, verbose=False)
            refs["fits"][name] = (
                jax.tree_util.tree_map(np.asarray, t.params),
                t.evaluate(fvl, load_best_model=False))

        refs["evaluator"] = {}
        for name in ("lightgcn", "srgnn"):
            ec = JConfig(config_dict=json.load(open(
                os.path.join(tmp, f"cfg_{name}.json"))))
            (_, etr), (evl, _), _ = data_preparation(ec, create_dataset(ec))
            em = j_get_model(ec["model"])(ec, etr)
            ep = jax.tree_util.tree_map(jnp.asarray, load_checkpoint(
                os.path.join(tmp, f"init_{name}.ckpt"))["params"])
            ev = JEvaluator(ec, em, mesh=mesh)
            refs["evaluator"][name] = (ev._use_dist_eval("full"),
                                       ev.evaluate(ep, {}, evl))
    return refs


def _port_single_fits(tmp, cd):
    from recbole_gnn_tpu_torch.train.trainer import Trainer
    out = {}
    for name in ("dense", "ell"):
        c, tl, vl, model = _port_model(dict(cd, **FIT_GRAPHS[name]))
        tr = Trainer(c, model)
        tr.resume_from_checkpoint(os.path.join(tmp, "init_lightgcn.ckpt"))
        tr.fit(tl, None, saved=False, verbose=False)
        out[name] = (_np(tr.params), tr.evaluate(vl, load_best_model=False))
    return out


def _write_inits(tmp):
    """Configs of the fixture at narrow widths and JAX-initialised
    checkpoints (epoch −1: a resumed fit starts at epoch 0)."""
    import jax
    from conftest import base_config_dict
    from recbole_gnn_tpu.config import Config as JConfig
    from recbole_gnn_tpu.models import get_model as j_get_model
    from recbole_gnn_tpu.quick_start import (create_dataset,
                                             data_preparation)
    from recbole_gnn_tpu.train.checkpoint import save_checkpoint
    from recbole_gnn_tpu.train.optim import make_optimizer
    from torch_parity_utils import jax_globals
    for name, model in (("lightgcn", "LightGCN"), ("srgnn", "SRGNN")):
        cd = base_config_dict(model=model, embedding_size=16, hidden_size=16,
                              n_layers=2, seed=2020, use_gpu=False,
                              epochs=1, checkpoint_dir=tmp)
        with open(os.path.join(tmp, f"cfg_{name}.json"), "w") as f:
            json.dump(cd, f)
        with pytest.MonkeyPatch.context() as mp:
            jax_globals(mp)
            c = JConfig(config_dict=cd)
            (_, tr), _, _ = data_preparation(c, create_dataset(c))
            params = j_get_model(model)(c, tr).init_params(
                jax.random.PRNGKey(0))
        save_checkpoint(os.path.join(tmp, f"init_{name}.ckpt"), {
            "params": params, "opt_state": make_optimizer("adam").init(
                params), "extras": {}, "epoch": np.int64(-1),
            "best_score": np.float64(np.nan), "best_epoch": np.int64(-1),
            "config": {"model": model, "dataset": "test"}})
    return json.load(open(os.path.join(tmp, "cfg_lightgcn.json")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ranks"))
    cd = _write_inits(tmp)
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
        refs = _jax_refs(tmp, cd)
        single = _port_single_fits(tmp, cd)
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
    return {"tmp": tmp, "cd": cd, "refs": refs, "single": single,
            "ranks": ranks}


# -- the tests ------------------------------------------------------------------

def test_make_mesh_over_the_group(runs):
    for r, got in enumerate(runs["ranks"]):
        m = got["mesh"]
        assert m["shape"] == (2, 2) and m["names"] == ("dp", "tp")
        assert m["coord"] == (r // 2, r % 2)
        assert m["all_dp"] == (WORLD,)
        assert m["sub_in"] == (r < 2)           # the first n ranks
        assert "needs 8 ranks" in m["too_big"] and "has 4" in m["too_big"]


@pytest.mark.parametrize("case", [0, 1])
def test_distributed_topk_matches_single_device_and_jax(runs, case):
    j_v, j_i, want = runs["refs"]["topk"][case]
    for got in runs["ranks"]:
        v, i = got["topk"][case]
        np.testing.assert_array_equal(i, want)
        np.testing.assert_array_equal(i, j_i)
        np.testing.assert_allclose(v, j_v, rtol=1e-6)
    if case == 1:
        assert want.max() < 60 and 0 not in want


@pytest.mark.parametrize("case", range(len(SPMM_CASES)))
def test_edge_sharded_spmm_forward_and_gradient(runs, case):
    j_out, j_g, want, want_g, j_multi = runs["refs"]["spmm"][case]
    edges = 0
    for got in runs["ranks"]:
        out, g, n_multi, n_edges = got["spmm"][case]
        edges += n_edges
        np.testing.assert_allclose(out, want, **SPMM_TOL)
        np.testing.assert_allclose(out, j_out, **SPMM_TOL)
        np.testing.assert_allclose(g, want_g, **SPMM_TOL)
        np.testing.assert_allclose(g, j_g, **SPMM_TOL)
    assert edges == SPMM_CASES[case][2]
    if SPMM_CASES[case][4]:                    # K_CAP 8: hubs split
        assert j_multi > 0
        assert max(got["spmm"][case][2] for got in runs["ranks"]) > 0


def test_dp_tp_step_matches_single_and_jax(runs):
    ref = runs["refs"]["step"]
    j_loss, j_params = ref["single"]
    s_loss, s_params = ref["sharded"]
    assert ref["plan"] == {"user_emb": (351, 352), "item_emb": (1005, 1006)}
    for got in runs["ranks"]:
        assert got["step"]["plan"] == ref["plan"]
        assert got["step"]["block_rows"] == {"user_emb": 176,
                                             "item_emb": 503}
        np.testing.assert_allclose(got["step"]["loss"], j_loss, rtol=1e-5)
        np.testing.assert_allclose(got["step"]["loss"], s_loss, rtol=1e-5)
        for k in ("user_emb", "item_emb"):
            np.testing.assert_allclose(got["step"]["params"][k], j_params[k],
                                       rtol=1e-4, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(got["step"]["params"][k], s_params[k],
                                       rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", list(FIT_GRAPHS))
def test_mesh_fit_matches_single_process_and_jax(runs, name):
    ref = "dense" if name == "dense" else "ell"
    j_params, j_metrics = runs["refs"]["fits"][ref]
    s_params, s_metrics = runs["single"][ref]
    for got in (r["fits"][name] for r in runs["ranks"]):
        assert got["plan"] == {"user_emb": (351, 352),
                               "item_emb": (1005, 1006)}
        assert got["graph"] == {"dense": "BipartiteDenseGraph",
                                "edge_sharded": "ShardedEll",
                                "ell": "Graph"}[name]
        for k in ("user_emb", "item_emb"):
            assert got["params"][k].shape == j_params[k].shape
            np.testing.assert_allclose(got["params"][k], j_params[k],
                                       err_msg=k, **FIT_TOL)
            np.testing.assert_allclose(got["params"][k], s_params[k],
                                       err_msg=k, **FIT_TOL)
        assert got["metrics"].keys() == j_metrics.keys()
        for k in j_metrics:
            np.testing.assert_allclose(got["metrics"][k], j_metrics[k],
                                       rtol=1e-5, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(got["metrics"][k], s_metrics[k],
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_mesh_checkpoint_is_logical_and_loads_in_both(runs):
    from recbole_gnn_tpu.train.checkpoint import load_checkpoint as j_load
    from recbole_gnn_tpu_torch.train.checkpoint import load_checkpoint
    path = os.path.join(runs["tmp"], "ck_dense", "LightGCN-test.ckpt")
    got = runs["ranks"][0]["fits"]["dense"]
    for state in (j_load(path), load_checkpoint(path)):
        assert int(state["epoch"]) == 0
        for k in ("user_emb", "item_emb"):
            np.testing.assert_array_equal(state["params"][k],
                                          got["params"][k])
            np.testing.assert_array_equal(state["opt_state"]["m"][k],
                                          got["m"][k])
        assert state["params"]["item_emb"].shape == (1005, 16)
        assert state["opt_state"]["v"]["user_emb"].shape == (351, 16)


@pytest.mark.parametrize("name", ["lightgcn", "srgnn"])
def test_mesh_evaluator_matches_jax(runs, name):
    j_dist, want = runs["refs"]["evaluator"][name]
    for got in runs["ranks"]:
        dist_, metrics = got["evaluator"][name]
        assert dist_ is j_dist is True        # both read only mode and tp
        assert metrics.keys() == want.keys()
        for k in want:
            assert abs(metrics[k] - want[k]) <= 1e-6, (name, k)


def test_query_and_http_with_mesh_shape(runs):
    from recbole_gnn_tpu.serve import RecServer as JRecServer
    from recbole_gnn_tpu_torch.serve import RecServer
    art = os.path.join(runs["tmp"], "lightgcn.npz")
    r0 = runs["ranks"][0]["serve"]
    users = r0["users"]
    single = RecServer(art, device="cpu")
    items, scores = single.recommend(users, k=5)
    want_ids = single.recommend(users, k=5, return_tokens=False)[0]
    j_ids = JRecServer(art, mesh_shape=[WORLD]).recommend(
        users, k=5, return_tokens=False)[0]
    np.testing.assert_array_equal(want_ids, j_ids)
    lines = [f"{u}: " + ", ".join(f"{t}:{v:.3f}" for t, v in zip(row, vs))
             for u, row, vs in zip(users, items, scores)]
    assert r0["query"].splitlines() == lines
    for r, got in enumerate(runs["ranks"]):
        assert got["serve"]["block_rows"] == 252   # 1,005 → 1,008 / 4
        np.testing.assert_array_equal(got["serve"]["ids"], want_ids)
        if r:
            assert got["serve"]["query"] == ""     # rank 0 prints
    assert r0["http"]["items"] == [row for row in items[:3]]
    np.testing.assert_allclose(r0["http"]["scores"], scores[:3], rtol=1e-6)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
