"""Port parity: the whole serving slice.

A checkpoint written by the JAX trainer is exported by both packages;
the artifacts, the recommendations and the cross-package reads must
agree.  The port runs on the CPU here (``use_gpu=False``).
"""

import importlib
import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from conftest import base_config_dict
from recbole_gnn_tpu.config import Config as JConfig
from recbole_gnn_tpu.data.dataset import GeneralGraphDataset as JDataset
from recbole_gnn_tpu.models.general.lightgcn import LightGCN as JLightGCN
from recbole_gnn_tpu.serve import RecServer as JRecServer
from recbole_gnn_tpu.serve import export_artifact as j_export
from recbole_gnn_tpu.train.trainer import Trainer as JTrainer
from recbole_gnn_tpu_torch import serve as t_serve
from recbole_gnn_tpu_torch.config import Config as TConfig
from recbole_gnn_tpu_torch.serve import RecServer as TRecServer
from recbole_gnn_tpu_torch.serve import export_artifact as t_export
from recbole_gnn_tpu_torch.train.checkpoint import save_checkpoint

# by module path: the JAX ops package re-exports a function named spmm
j_spmm_mod = importlib.import_module("recbole_gnn_tpu.ops.spmm")
j_pallas_mod = importlib.import_module("recbole_gnn_tpu.ops.pallas_spmm")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 10


def _cfg(tmp, **over):
    return base_config_dict(model="LightGCN", checkpoint_dir=str(tmp),
                            embedding_size=16, n_layers=3, seed=2020,
                            use_gpu=False, **over)


@pytest.fixture(scope="module", params=[{}, {"enable_sparse": True,
                                             "sparse_spmm_impl": "pallas"}],
                ids=["dense", "sparse"])
def exported(request, tmp_path_factory):
    """A JAX-trainer checkpoint, exported by both packages."""
    tmp = tmp_path_factory.mktemp("serve")
    cd = _cfg(tmp, **request.param)
    jc = JConfig(config_dict=cd)
    model = JLightGCN(jc, JDataset(jc).build()[0])
    trainer = JTrainer(jc, model)
    params = model.init_params(jax.random.PRNGKey(11))
    trainer._save(params, trainer.optimizer.init(params), {}, epoch=0)
    # the JAX export sets module globals of the JAX package: restore
    # them so later JAX tests in this worker see the defaults
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_spmm_mod, "SPMM_IMPL", j_spmm_mod.SPMM_IMPL)
        mp.setattr(j_pallas_mod, "DEFAULT_PRECISION",
                   j_pallas_mod.DEFAULT_PRECISION)
        j_art = j_export(jc, str(tmp / "jax.npz"))
    t_art = t_export(TConfig(config_dict=cd), str(tmp / "torch.npz"))
    return cd, tmp, j_art, t_art


def test_artifacts_equal(exported):
    _, _, j_art, t_art = exported
    with np.load(j_art, allow_pickle=True) as j, \
            np.load(t_art, allow_pickle=False) as t:
        assert set(j.files) == set(t.files)
        np.testing.assert_allclose(t["user_table"], j["user_table"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t["item_table"], j["item_table"],
                                   rtol=1e-5, atol=1e-6)
        for k in ("hist_indptr", "hist_items"):
            np.testing.assert_array_equal(t[k], j[k])
        for k in ("user_tokens", "item_tokens"):
            assert t[k].dtype.kind == "U"          # no pickled objects
            assert t[k].tolist() == [str(v) for v in j[k]]
        jm = json.loads(bytes(j["meta"]).decode())
        tm = json.loads(bytes(t["meta"]).decode())
        assert jm == tm


def _users_with_room(srv, n: int) -> list:
    """Users with at least K unmasked items, so the top-k never reaches
    the -1e30 mask (whose tie order differs between the two top-ks)."""
    lens = np.diff(srv._hist_indptr)
    ok = [u for u in range(1, srv.n_users)
          if srv.n_items - 1 - lens[u] >= K]
    return [str(srv.user_tokens[u]) for u in ok[:n]]


def test_recommend_equal_to_jax(exported):
    _, _, j_art, t_art = exported
    js, ts = JRecServer(j_art), TRecServer(t_art, device="cpu")
    users = _users_with_room(ts, 6)
    ji, jv = js.recommend(users, k=K, return_tokens=False)
    ti, tv = ts.recommend(users, k=K, return_tokens=False)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-5, atol=1e-7)
    items, _ = ts.recommend(users[:2], k=3)
    assert items == [[str(ts.item_tokens[i]) for i in row] for row in ti[:2, :3]]
    for b, u in enumerate(ts.resolve_users(users)):
        hist = ts._hist_items[ts._hist_indptr[u]:ts._hist_indptr[u + 1]]
        assert 0 not in ti[b] and not np.isin(ti[b], hist).any()


def test_recommend_unmasked_and_empty(exported):
    _, _, _, t_art = exported
    ts = TRecServer(t_art, device="cpu")
    users = _users_with_room(ts, 2)
    idx, vals = ts.recommend(users, k=K, mask_history=False,
                             return_tokens=False)
    assert 0 not in idx                       # PAD stays masked
    scores = (ts.user_table[ts.resolve_users(users)] @ ts.item_table.T).numpy()
    scores[:, 0] = -np.inf
    np.testing.assert_allclose(vals, -np.sort(-scores, axis=1)[:, :K],
                               rtol=1e-5, atol=1e-7)
    items, sc = ts.recommend([], k=5)
    assert items == [] and sc.shape == (0, 5)
    with pytest.raises(KeyError):
        ts.recommend(["no-such-user"], k=5)


def test_jax_server_reads_port_artifact(exported):
    _, _, j_art, t_art = exported
    users = _users_with_room(TRecServer(t_art, device="cpu"), 4)
    a, _ = JRecServer(t_art).recommend(users, k=K, return_tokens=False)
    b, _ = JRecServer(j_art).recommend(users, k=K, return_tokens=False)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_refuses_pickled_artifact(exported):
    """The JAX package writes its vocabularies as object arrays; the
    port loads artifacts with allow_pickle=False and refuses them."""
    _, _, j_art, _ = exported
    with pytest.raises(ValueError, match="pickle"):
        TRecServer(j_art, device="cpu")


def test_export_refuses_other_models_checkpoint(exported):
    cd, tmp, _, _ = exported
    for stored in ({"model": "NGCF", "dataset": "test"},
                   {"model": "LightGCN", "dataset": "ml-1m"}):
        path = str(tmp / "other.ckpt")
        save_checkpoint(path, {"params": {}, "extras": {}, "config": stored})
        with pytest.raises(ValueError, match="stored for"):
            t_export(TConfig(config_dict=cd), str(tmp / "never.npz"),
                     checkpoint_path=path)
    assert not os.path.exists(tmp / "never.npz")


def test_entry_points_need_use_gpu_false_without_cuda(exported):
    cd, tmp, _, t_art = exported
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run there")
    no_flag = {k: v for k, v in cd.items() if k != "use_gpu"}
    with pytest.raises(RuntimeError, match="--use_gpu=False"):
        t_export(TConfig(config_dict=no_flag), str(tmp / "never.npz"))
    with pytest.raises(RuntimeError, match="--use_gpu=False"):
        TRecServer(t_art)
    assert TRecServer(t_art, device="cpu").device.type == "cpu"


def test_full_sort_topk_matches_jax():
    from recbole_gnn_tpu.ops.topk import full_sort_topk as j_topk
    from recbole_gnn_tpu_torch.ops.topk import full_sort_topk as t_topk
    rng = np.random.default_rng(9)
    u = rng.normal(size=(5, 8)).astype(np.float32)
    items = rng.normal(size=(300, 8)).astype(np.float32)
    mask = rng.random((5, 300)) < 0.3
    jv, ji = j_topk(u, items, mask, K)
    tv, ti = t_topk(torch.from_numpy(u), torch.from_numpy(items),
                    torch.from_numpy(mask), K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    assert not np.take_along_axis(mask, ti.numpy(), axis=1).any()


def test_sequential_export_rejected(tmp_path):
    cd = base_config_dict(model="SRGNN", use_gpu=False,
                          checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="sequential"):
        t_export(TConfig(config_dict=cd), str(tmp_path / "never.npz"))


def test_http_roundtrip(exported):
    _, _, _, t_art = exported
    srv = TRecServer(t_art, device="cpu")
    httpd = t_serve.make_http_server(srv, "127.0.0.1", 0)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["model"] == "LightGCN"
        user = _users_with_room(srv, 1)[0]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/recommend",
            data=json.dumps({"users": [user], "k": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        want, _ = srv.recommend([user], k=3)
        assert out["items"] == want and out["users"] == [user]
        bad = urllib.request.Request(
            f"http://127.0.0.1:{port}/recommend",
            data=json.dumps({"users": ["nope"], "k": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=30)
        assert ei.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_concurrent_recommend_threads(exported):
    """RecServer keeps no per-call state: concurrent callers (the
    threading HTTP server) all get the single-threaded answer."""
    _, _, _, t_art = exported
    srv = TRecServer(t_art, device="cpu")
    users = _users_with_room(srv, 8)
    want, _ = srv.recommend(users, k=K, return_tokens=False)
    errors = []

    def worker(i):
        try:
            for _ in range(5):
                got, _ = srv.recommend(users[i % 4:] + users[:i % 4], k=K,
                                       return_tokens=False)
                rot = np.roll(want, -(i % 4), axis=0)
                if not np.array_equal(got, rot):
                    errors.append(i)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors


def test_cli_export_and_query(exported, capsys):
    cd, tmp, _, _ = exported
    out = str(tmp / "cli.npz")
    extra = [f"--{k}={v}" for k, v in cd.items()
             if k in ("data_path", "checkpoint_dir", "embedding_size",
                      "n_layers", "seed", "enable_sparse",
                      "sparse_spmm_impl", "use_gpu")]
    t_serve.main(["export", "-m", "LightGCN", "-d", "test", "--out", out,
                  *extra])
    srv = TRecServer(out, device="cpu")
    tok = _users_with_room(srv, 1)[0]
    t_serve.main(["query", "--artifact", out, "--users", tok, "-k", "3",
                  "--use_gpu=False"])
    text = capsys.readouterr().out
    assert f"wrote {out}" in text and f"{tok}: " in text
    # --mesh_shape: a mesh of one is accepted and answers the same; more
    # ranks than the (absent) process group say how to launch
    t_serve.main(["query", "--artifact", out, "--users", tok, "-k", "3",
                  "--use_gpu=False", "--mesh_shape=[1]"])
    assert capsys.readouterr().out.strip() == \
        text.strip().splitlines()[-1]
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node=8"):
        t_serve.main(["query", "--artifact", out, "--users", tok,
                      "--use_gpu=False", "--mesh_shape=[8]"])


def test_port_imports_neither_jax_nor_jax_package():
    """A fresh interpreter importing every port module must leave jax
    and recbole_gnn_tpu (not _torch) out of sys.modules."""
    code = r"""
import importlib, pkgutil, re, sys
import recbole_gnn_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules
       if re.match(r"(jax|jaxlib)(\.|$)|recbole_gnn_tpu(?!_torch)(\.|$)", m)]
assert not bad, bad
print(len(names))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 34
