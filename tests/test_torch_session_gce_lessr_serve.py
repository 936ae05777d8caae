"""Port parity: ``SessionServer`` for GCE-GNN and LESSR.

From one checkpoint per model that the JAX package wrote (its init
params), the port's server answers
the fixture's test sessions with the JAX server's top-10 (ids equal,
scores rtol 1e-5 / atol 1e-6) and with its own model's full sort of the
same sessions; GCE-GNN's requests are reversed, as its training
sessions are.  LESSR's server calibrates its BatchNorm statistics on
the JAX server's 1,024 training sessions (rtol 1e-5 / atol 1e-6 against
the JAX extras), and its scores are the same whether the request's
mailbox is padded to a power of 2 (the JAX server's jit-cache bound) or
not.  One HTTP round trip each.
"""

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from recbole_gnn_tpu.config import Config as JConfig
from recbole_gnn_tpu.serve import SessionServer as JSessionServer
from recbole_gnn_tpu.train.checkpoint import save_checkpoint as j_save
from recbole_gnn_tpu_torch import serve as t_serve
from recbole_gnn_tpu_torch.config import Config as TConfig
from recbole_gnn_tpu_torch.data.session import reverse_sessions
from recbole_gnn_tpu_torch.eval.evaluator import to_device
from recbole_gnn_tpu_torch.ops.topk import NEG_INF
from torch_parity_utils import both, jax_globals, seq_cfg

MODELS = ["GCEGNN", "LESSR"]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Per model: its config, the port's server and the JAX server from
    one checkpoint the JAX package wrote (its init params), and the
    port's test loader and model."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_globals(mp)
        for model in MODELS:
            d = tmp_path_factory.mktemp(model)
            # LESSR with one EOPA and one SGAT layer
            over = {"n_layers": 2} if model == "LESSR" else {}
            cd = seq_cfg(model, checkpoint_dir=str(d), **over)
            (_, _, jm), (_, (_, _, test_loader), tm) = both(cd)
            j_save(str(d / f"{model}-test.ckpt"), {
                "params": jm.init_params(jax.random.PRNGKey(3)),
                "extras": {}, "epoch": np.int64(0),
                "config": {"model": model, "dataset": "test"}})
            srv = t_serve.SessionServer(TConfig(config_dict=cd),
                                        device="cpu")
            j_srv = JSessionServer(JConfig(config_dict=cd))
            out[model] = (cd, srv, j_srv, test_loader, tm)
    return out


def test_served_top_k_matches_jax_and_the_model(servers):
    for model in MODELS:
        cd, srv, j_srv, test_loader, tm = servers[model]
        assert srv.meta["model"] == model
        batch = next(iter(test_loader))
        rows = np.flatnonzero(batch["weight"] > 0)[:40]
        seqs = batch["item_seq"]
        if model == "GCEGNN":   # the loader's sessions are reversed
            seqs = reverse_sessions(seqs, batch["item_seq_len"])
        sessions = [[str(srv.item_tokens[i])
                     for i in seqs[r][:batch["item_seq_len"][r]]]
                    for r in rows]
        got_idx, got_vals = srv.recommend(sessions, k=10,
                                          return_tokens=False)
        assert not (got_idx == 0).any()
        j_idx, j_vals = j_srv.recommend(sessions, k=10, return_tokens=False)
        np.testing.assert_array_equal(got_idx, j_idx, err_msg=model)
        np.testing.assert_allclose(got_vals, j_vals, rtol=1e-5, atol=1e-6)
        # the model's own full sort of the loader's batch (LESSR with the
        # server's calibrated statistics)
        with torch.no_grad():
            scores = tm.full_scores(srv.params, tm.consts, srv.extras,
                                    to_device(batch, "cpu"), None, False)
        scores[:, 0] = NEG_INF
        want_vals, want_idx = torch.topk(scores[rows], 10)
        np.testing.assert_array_equal(got_idx, want_idx.numpy())
        np.testing.assert_allclose(got_vals, want_vals.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_lessr_server_calibration_and_mailbox_width(servers):
    cd, srv, j_srv, test_loader, tm = servers["LESSR"]
    got, want = srv.extras["lessr_bn"], j_srv.extras["lessr_bn"]
    assert len(got) == len(want) == tm.num_layers + 2
    for (gm, gv), (wm, wv) in zip(got, want):
        np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                                   atol=1e-6)
    toks = [str(srv.item_tokens[i]) for i in (3, 5, 3, 7, 3, 9)]
    batch, n = srv.session_batch([toks, toks[:2]])
    mail = batch["eop_mail"]
    assert mail.shape[2] == 2           # item 3 follows items 5 and 7
    padded = dict(batch, eop_mail=np.pad(mail, ((0, 0), (0, 0), (0, 1))))
    with torch.no_grad():
        a, b = (tm.full_scores(srv.params, tm.consts, srv.extras,
                               to_device(x, "cpu"), None, False)
                for x in (batch, padded))
    assert torch.equal(a, b)


@pytest.mark.parametrize("model", MODELS)
def test_session_http_roundtrip(servers, model):
    _, srv, _, _, _ = servers[model]
    httpd = t_serve.make_http_server(srv, "127.0.0.1", 0)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        toks = [[str(srv.item_tokens[i]) for i in (3, 5)],
                [str(srv.item_tokens[7])]]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/recommend",
            data=json.dumps({"sessions": toks, "k": 4}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        items, scores = srv.recommend(toks, k=4)
        assert out["sessions"] == toks and out["items"] == items
        np.testing.assert_allclose(out["scores"], scores, rtol=1e-6)
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    assert not th.is_alive()
