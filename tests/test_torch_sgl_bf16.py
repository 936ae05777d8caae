"""Port parity: SGL with ``activation_dtype: bfloat16``.

The propagations start from a bf16 copy of the embeddings, each layer
keeps the dtype its SpMM gives and the layer mean is taken in f32; the
port must give every layer the JAX package's dtype (bf16 on ``ell``,
``xla`` and, on the CPU, ``pallas``; f32 after the first dense layer)
and match its views, loss and gradients.  From one JAX-initialised set
of params with the JAX keep masks injected, on dense, ``ell``, ``xla``
and ``pallas`` (ED; ND and RW on ``ell``):

* views: the f32 edge weights, as without bf16: rtol 1e-5 / atol 1e-6;
* loss and parts: rtol 1e-2 (measured: within 2.1e-6);
* the propagated tables: ``|Δ| ≤ 1e-2·max|ref|`` (measured: 1e-7 on
  dense and ``ell``, 2.6e-3 on ``xla``, 3.4e-3 on ``pallas``, where the
  JAX CPU path sums its bf16 messages in bf16 and the port's D1 in f32);
* gradients: ``max|Δ| ≤ 3e-2·max|g|`` and ``‖Δ‖ ≤ 2e-2·‖g‖`` per leaf.
  The cotangents run in bf16 through the layers into the all-node
  InfoNCE, and each package rounds them at its own places.  Measured on
  these inputs: JAX's own bf16 gradient sits up to 1.2e-2·max|g| (norm
  0.66e-2) from its f32 gradient, the port's up to 1.8e-2 (norm 1.04e-2,
  on ``pallas``, whose CPU path sums in bf16), and the two up to
  1.75e-2·max|g| (norm 1.08e-2) apart.

Then the ROADMAP gate from one JAX checkpoint on ``ell`` (per-epoch
losses rtol 1e-4, test metrics abs 1e-3, as the f32 gate), the JAX
package's own quality check repeated in the port (bf16 within 0.02 of
f32 on ndcg@10 and recall@10 after 3 epochs, dense and
``enable_sparse``), the CLI, and serving from the bf16 checkpoint.
"""

import importlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from recbole_gnn_tpu_torch.eval.evaluator import to_device
from recbole_gnn_tpu_torch.train.optim import tree_leaves
from test_torch_general_sgl import _inject_sgl, sgl_keeps
from torch_parity_utils import (LOSS_TOL, assert_tree_close, both, cfg,
                                check_gate, jax_globals, jax_loss_and_grads,
                                padded_batch, port_params, resumed_runs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = {"activation_dtype": "bfloat16"}
PART_RTOL = 1e-2
TABLE_REL = 1e-2
GRAD_MAX_REL = 3e-2
GRAD_NORM_REL = 2e-2

CASES = [("ED", "dense"), ("ED", "ell"), ("ED", "xla"), ("ED", "pallas"),
         ("ND", "ell"), ("RW", "ell")]


def _models(aug, graph):
    (_, (jtl, _, _), jm), (_, _, tm) = both(cfg("SGL", graph, type=aug,
                                                drop_ratio=0.2, **BF16))
    key = jax.random.PRNGKey(11)
    j_extras = jm._make_extras(key, jm.consts)
    t_extras = tm.init_extras(None, keeps=sgl_keeps(jm, key))
    return jtl, jm, tm, j_extras, t_extras


@pytest.mark.parametrize("aug,graph", CASES, ids=[f"{a}-{g}" for a, g in CASES])
def test_sgl_bf16_views_loss_and_grads_match_jax(monkeypatch, aug, graph):
    jax_globals(monkeypatch)
    jtl, jm, tm, j_extras, t_extras = _models(aug, graph)
    assert tm.act_dtype == torch.bfloat16
    for k in t_extras:
        assert_tree_close(t_extras[k], j_extras[k], LOSS_TOL, k)
        for leaf in tree_leaves(t_extras[k]):
            assert leaf.dtype == torch.float32        # the views stay f32
    batch = padded_batch(jtl)
    jp = jm.init_params(jax.random.PRNGKey(3))
    (jl, jaux), jg = jax_loss_and_grads(jm, jp, batch, jax.random.PRNGKey(0),
                                        j_extras)
    tp = port_params(jp)
    tl, taux = tm.calculate_loss(tp, tm.consts, t_extras,
                                 to_device(batch, "cpu"), None)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=PART_RTOL)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   rtol=PART_RTOL, err_msg=k)
    tg = torch.autograd.grad(tl, tree_leaves(tp))
    for i, (g, want) in enumerate(zip(tg, jax.tree_util.tree_leaves(jg))):
        want = np.asarray(want)
        assert g.dtype == torch.float32               # params stay f32
        d = g.numpy() - want
        assert np.abs(d).max() <= GRAD_MAX_REL * np.abs(want).max(), i
        assert np.linalg.norm(d) <= GRAD_NORM_REL * np.linalg.norm(want), i
    tu, ti = tm.propagate(port_params(jp, grad=False), tm.consts, t_extras)
    ju, ji = jm.propagate(jp, jm.consts, j_extras)
    for got, want in ((tu, ju), (ti, ji)):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        assert np.abs(got.numpy() - want).max() <= \
            TABLE_REL * np.abs(want).max()


@pytest.mark.parametrize("graph", ["dense", "ell", "xla", "pallas"])
def test_sgl_bf16_layer_dtypes_match_jax(monkeypatch, graph):
    """Every layer's input and output dtype, in each propagation, equals
    the JAX package's (recorded around each package's SpMM call)."""
    jax_globals(monkeypatch)
    jtl, jm, tm, j_extras, t_extras = _models("ED", graph)
    jp = jm.init_params(jax.random.PRNGKey(3))
    seen = {"jax": [], "torch": []}

    def recorder(mod, name, side, fmt):
        real = getattr(mod, name)

        def wrapped(g, x):
            y = real(g, x)
            seen[side].append((fmt(x.dtype), fmt(y.dtype)))
            return y
        monkeypatch.setattr(mod, name, wrapped)

    j_sgl = importlib.import_module("recbole_gnn_tpu.models.general.sgl")
    t_sgl = importlib.import_module("recbole_gnn_tpu_torch.models.general.sgl")
    for name in ("spmm_any", "spmm_dense_bipartite"):
        recorder(j_sgl, name, "jax", lambda dt: str(np.dtype(dt)))
        recorder(t_sgl, name, "torch",
                 lambda dt: str(dt).replace("torch.", ""))
    jm._forward_base(jp, jm.consts)
    tm._forward_base(port_params(jp, grad=False), tm.consts)
    for view in ("view1", "view2"):
        ell = ((j_extras[f"{view}_ell"], j_extras[f"{view}_ell_r"])
               if graph == "ell" else ())
        jm._forward_view(jp, jm.consts, j_extras[view], *ell)
        tm._forward_view(port_params(jp, grad=False), tm.consts, t_extras,
                         view)
    assert len(seen["torch"]) == 3 * tm.n_layers
    assert seen["torch"] == seen["jax"]
    first = ("bfloat16", "float32" if graph == "dense" else "bfloat16")
    assert seen["torch"][0] == first


@pytest.fixture(scope="module")
def sgl_bf16_gate(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sgl_bf16_gate")
    cd = cfg("SGL", "ell", checkpoint_dir=str(tmp), eval_step=1, **BF16)
    return resumed_runs(tmp, cd, _inject_sgl)


def test_sgl_bf16_two_epochs_from_a_jax_checkpoint_match_jax(sgl_bf16_gate):
    check_gate(sgl_bf16_gate)
    tm = sgl_bf16_gate["torch"][3]
    assert tm.act_dtype == torch.bfloat16


def _quick(tmp_path, **over):
    from recbole_gnn_tpu_torch.quick_start import run_recbole_gnn_tpu
    cd = cfg("SGL", "dense", epochs=3, checkpoint_dir=str(tmp_path),
             **over)
    return run_recbole_gnn_tpu(model="SGL", dataset="test", config_dict=cd,
                               saved=True, verbose=False)["test_result"]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_sgl_bf16_quality_tracks_f32(tmp_path, sparse):
    """The JAX package's own check (``test_sgl_bf16_activations_quality``
    and ``test_sgl_bf16_sparse_path_quality``) in the port: 3 epochs
    from one seed, bf16 within 0.02 of f32 on ndcg@10 and recall@10."""
    over = {"enable_sparse": True} if sparse else {}
    f32 = _quick(tmp_path / "f32", **over)
    bf16 = _quick(tmp_path / "bf16", **over, **BF16)
    for k in ("ndcg@10", "recall@10"):
        assert np.isfinite(bf16[k])
        assert abs(f32[k] - bf16[k]) < 0.02, (k, f32[k], bf16[k])


def test_sgl_bf16_cli_trains_and_serves(tmp_path):
    """``run -m SGL --activation_dtype=bfloat16`` on the CPU trains and
    checkpoints; the export of that checkpoint holds the f32 tables of
    the bf16 propagation, and ``RecServer`` serves them."""
    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.serve import RecServer, export_artifact
    log = tmp_path / "log.jsonl"
    data = os.path.join(ROOT, "tests", "test_data")
    r = subprocess.run(
        [sys.executable, "-m", "recbole_gnn_tpu_torch.run", "-m", "SGL",
         "-d", "test", f"--data_path={data}", "--epochs=1", "--state=ERROR",
         "--use_gpu=False", "--embedding_size=16", "--enable_sparse=True",
         "--activation_dtype=bfloat16", f"--checkpoint_dir={tmp_path}",
         f"--metrics_log_path={log}"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    events = [json.loads(line) for line in open(log)]
    assert np.isfinite([e["loss"] for e in events
                        if e["event"] == "train_epoch"]).all()
    config = Config(model="SGL", dataset="test", config_dict={
        "data_path": data, "checkpoint_dir": str(tmp_path),
        "embedding_size": 16, "enable_sparse": True, "use_gpu": False,
        "activation_dtype": "bfloat16"})
    art = export_artifact(config, str(tmp_path / "sgl.npz"), device="cpu")
    srv = RecServer(art, device="cpu")
    assert srv.item_table.dtype == torch.float32
    users = [str(u) for u in srv.user_tokens[1:6]]
    items, scores = srv.recommend(users, k=5)
    assert len(items) == 5 and np.isfinite(np.asarray(scores)).all()
