"""Port parity: sequential evaluation and ``SessionServer``.

From one JAX checkpoint (SRGNN and SASRec, one epoch on the fixture):
the port's ``Evaluator`` gives the JAX package's metrics in full sort
(PAD column masked, no history mask), uni100 and pop100 (abs 1e-6:
f32 sums of the same terms in another order); ``SessionServer`` serves
the checkpoint with the top-k of the evaluator's full sort for the same
sessions and the JAX server's scores (rtol 1e-5 / atol 1e-6), pads
requests to the 1 / 8 / 64 / 256 buckets, answers over HTTP, and
refuses non-sequential models and a checkpoint of another model
(GCEGNN and LESSR too: they are served, ``test_torch_session_gce_lessr_serve.py``).
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from recbole_gnn_tpu.config import Config as JConfig
from recbole_gnn_tpu.eval.evaluator import Evaluator as JEvaluator
from recbole_gnn_tpu.quick_start import run_recbole_gnn_tpu as j_run
from recbole_gnn_tpu.serve import SessionServer as JSessionServer
from recbole_gnn_tpu.train.checkpoint import load_checkpoint as j_load
from recbole_gnn_tpu_torch import serve as t_serve
from recbole_gnn_tpu_torch.config import Config as TConfig
from recbole_gnn_tpu_torch.eval.evaluator import Evaluator as TEvaluator
from recbole_gnn_tpu_torch.eval.evaluator import to_device
from recbole_gnn_tpu_torch.ops.topk import NEG_INF
from recbole_gnn_tpu_torch.train.checkpoint import params_from_numpy
from torch_parity_utils import both, jax_globals, seq_cfg

MODES = {"full": "full", "uni100": "uni100", "pop100": "pop100"}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One JAX-trained checkpoint per model, in its own directory."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_globals(mp)
        for model in ("SRGNN", "SASRec"):
            d = tmp_path_factory.mktemp(model)
            cd = seq_cfg(model, epochs=1, checkpoint_dir=str(d))
            j_run(config_dict=cd, saved=True, verbose=False)
            out[model] = cd
    return out


def eval_cfg(cd, mode):
    return dict(cd, eval_args={"split": {"LS": "valid_and_test"},
                               "mode": mode, "order": "TO"})


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("model", ["SRGNN", "SASRec"])
def test_sequential_evaluation_matches_jax(monkeypatch, ckpts, model, mode):
    jax_globals(monkeypatch)
    cd = eval_cfg(ckpts[model], mode)
    state = j_load(f"{cd['checkpoint_dir']}/{model}-test.ckpt")
    (jc, (_, jvl, jte), jm), (tc, (_, tvl, tte), tm) = both(cd)
    em = "full" if mode == "full" else "candidates"
    tp = params_from_numpy(state["params"], "cpu")
    for jl, tl in ((jvl, tvl), (jte, tte)):
        want = JEvaluator(jc, jm).evaluate(state["params"], {}, jl, mode=em)
        got = TEvaluator(tc, tm).evaluate(tp, {}, tl, mode=em)
        assert got.keys() == want.keys() and "recall@10" in got
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
        assert 0 < got["recall@10"] <= 1


@pytest.mark.parametrize("model", ["SRGNN", "SASRec"])
def test_session_server_matches_evaluator_and_jax(monkeypatch, ckpts, model):
    jax_globals(monkeypatch)
    cd = ckpts[model]
    srv = t_serve.SessionServer(TConfig(config_dict=cd), device="cpu")
    assert srv.meta["model"] == model
    _, (tc, (_, _, test_loader), tm) = both(cd)
    batch = next(iter(test_loader))
    rows = np.flatnonzero(batch["weight"] > 0)[:40]
    sessions = [[str(srv.item_tokens[i])
                 for i in batch["item_seq"][r][:batch["item_seq_len"][r]]]
                for r in rows]
    got_idx, got_vals = srv.recommend(sessions, k=10, return_tokens=False)
    # the evaluator's full sort of the same sessions
    with torch.no_grad():
        scores = tm.full_scores(srv.params, tm.consts, {},
                                to_device(batch, "cpu"), None, False)
    scores[:, 0] = NEG_INF
    want_vals, want_idx = torch.topk(scores[rows], 10)
    np.testing.assert_array_equal(got_idx, want_idx.numpy())
    np.testing.assert_allclose(got_vals, want_vals.numpy(), rtol=1e-6)
    assert not (got_idx == 0).any()
    # the JAX server's answer from the same checkpoint
    j_srv = JSessionServer(JConfig(config_dict=cd))
    j_idx, j_vals = j_srv.recommend(sessions, k=10, return_tokens=False)
    np.testing.assert_array_equal(got_idx, j_idx)
    np.testing.assert_allclose(got_vals, j_vals, rtol=1e-5, atol=1e-6)
    items, _ = srv.recommend(sessions[:2], k=3)
    assert items == [[str(srv.item_tokens[j]) for j in r]
                     for r in got_idx[:2, :3]]


def test_session_server_buckets_and_refusals(ckpts):
    cd = ckpts["SRGNN"]
    srv = t_serve.SessionServer(TConfig(config_dict=cd), device="cpu")
    tok = [str(srv.item_tokens[i]) for i in (3, 5, 7)]
    for n, bucket in ((1, 1), (3, 8), (9, 64), (65, 256), (300, 512)):
        batch, real = srv.session_batch([tok] * n)
        assert real == n and batch["item_seq"].shape == (bucket, 20)
        assert batch["x"].shape == (bucket, 20)
    long = [str(srv.item_tokens[i % 50 + 1]) for i in range(30)]
    batch, _ = srv.session_batch([long])
    assert int(batch["item_seq_len"][0]) == 20          # the last 20 items
    items, scores = srv.recommend([], k=5)
    assert items == [] and scores.shape == (0, 5)
    with pytest.raises(KeyError, match="unknown item token"):
        srv.recommend([["no-such-item"]])
    with pytest.raises(KeyError, match="empty session"):
        srv.recommend([[]])
    # GCEGNN and LESSR are served now: they pass the dataset-class check
    # and stop at the checkpoint's model check
    for model in ("GCEGNN", "LESSR"):
        with pytest.raises(ValueError, match="stored for"):
            t_serve.SessionServer(
                TConfig(config_dict=dict(cd, model=model)),
                checkpoint_path=f"{cd['checkpoint_dir']}/SRGNN-test.ckpt",
                device="cpu")
    with pytest.raises(ValueError, match="sequential"):
        t_serve.SessionServer(TConfig(config_dict=dict(cd, model="LightGCN")),
                              device="cpu")
    with pytest.raises(ValueError, match="stored for"):
        t_serve.SessionServer(
            TConfig(config_dict=dict(cd, model="NISER")),
            checkpoint_path=f"{cd['checkpoint_dir']}/SRGNN-test.ckpt",
            device="cpu")


def test_session_http_roundtrip(ckpts):
    srv = t_serve.SessionServer(TConfig(config_dict=ckpts["SASRec"]),
                                device="cpu")
    httpd = t_serve.make_http_server(srv, "127.0.0.1", 0)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        toks = [[str(srv.item_tokens[i]) for i in (3, 5)],
                [str(srv.item_tokens[9])]]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/recommend",
            data=json.dumps({"sessions": toks, "k": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        items, scores = srv.recommend(toks, k=4)
        assert out["sessions"] == toks and out["items"] == items
        np.testing.assert_allclose(out["scores"], scores, rtol=1e-6)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        assert health["model"] == "SASRec" and health["n_items"] == srv.n_items
        bad = urllib.request.Request(
            f"http://127.0.0.1:{port}/recommend",
            data=json.dumps({"sessions": [["no-such-item"]]}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=60)
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    assert not th.is_alive()


def test_session_cli_one_shot(ckpts, capsys):
    cd = ckpts["SRGNN"]
    srv = t_serve.SessionServer(TConfig(config_dict=cd), device="cpu")
    toks = [str(srv.item_tokens[i]) for i in (3, 5)]
    items, _ = srv.recommend([toks], k=3)
    t_serve.main(["session", "-m", "SRGNN", "-d", "test", "--session", *toks,
                  "-k", "3", "--use_gpu=False",
                  f"--data_path={cd['data_path']}",
                  f"--checkpoint_dir={cd['checkpoint_dir']}",
                  "--MAX_ITEM_LIST_LENGTH=20", "--embedding_size=16"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(" ".join(toks) + " -> ")
    assert [p.split(":")[0] for p in line.split(" -> ")[1].split(", ")] == \
        items[0]
