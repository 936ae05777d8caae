"""Serving path: export a trained model to a standalone artifact, then
answer top-k recommendation queries from it.

Port of ``recbole_gnn_tpu/serve.py`` (``export_artifact``,
``RecServer``, ``make_http_server`` and the ``export``/``query``/
``http`` CLI verbs; the artifact's keys and meta are the same, so each
package's server reads the other's artifacts).  A factorized model
collapses at serving time to two dense tables: propagate once, then
every query is one (B, d) × (d, n_items) product, the history and PAD
mask, and an exact top-k.

Entry points run on the card unless the caller asks for the CPU
(``--use_gpu=False``, config ``use_gpu: False`` or ``device="cpu"``).

CLI:
  python -m recbole_gnn_tpu_torch.serve export -m LightGCN -d ml-100k \
      [--config_files ...] [--checkpoint saved/LightGCN-ml-100k.ckpt] \
      --out /tmp/lightgcn.artifact.npz [--key=value ...]
  python -m recbole_gnn_tpu_torch.serve query --artifact /tmp/... \
      --users 196 186 22 -k 10 [--use_gpu=False]
  python -m recbole_gnn_tpu_torch.serve http --artifact /tmp/... --port 8080
      # POST /recommend {"users": ["196"], "k": 10}; GET /healthz
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from recbole_gnn_tpu_torch.models import get_model
from recbole_gnn_tpu_torch.ops.topk import NEG_INF, masked_topk
from recbole_gnn_tpu_torch.quick_start import create_dataset, resolve_device
from recbole_gnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   params_from_numpy)
from recbole_gnn_tpu_torch.utils.enums import ModelType

ARTIFACT_VERSION = 1


# -- export -------------------------------------------------------------

def export_artifact(config, out_path: str, checkpoint_path: str | None = None,
                    mask_splits: str = "all", compress: bool = False,
                    device: torch.device | str | None = None) -> str:
    """Propagate a trained checkpoint once and write the serving artifact.

    ``checkpoint_path``: defaults to the trainer's save path
    (``{checkpoint_dir}/{model}-{dataset}.ckpt``); its stored
    ``config.model``/``config.dataset`` must equal ``config``'s.
    ``mask_splits``: which observed interactions the server masks out of
    recommendations — ``"all"`` (train+valid+test), ``"train+valid"``
    (the test-time evaluator convention) or ``"train"``.
    ``device``: where the propagation runs (default per
    :func:`resolve_device`).
    """
    dev = resolve_device(config, device)
    if config["MODEL_TYPE"] == ModelType.SEQUENTIAL:
        raise ValueError(
            "sequential models score sessions, not user ids — session "
            "serving is not ported yet (ROADMAP §1 Slice C item 6)")
    ckpt = checkpoint_path or os.path.join(
        config["checkpoint_dir"] or "saved/",
        f"{config['model']}-{config['dataset']}.ckpt")
    state = load_checkpoint(ckpt)
    stored = state.get("config") or {}
    want = {"model": str(config["model"]), "dataset": str(config["dataset"])}
    got = {k: (None if stored.get(k) is None else str(stored.get(k)))
           for k in want}
    if got != want:
        raise ValueError(
            f"checkpoint {ckpt!r} was stored for {got}, not for the export "
            f"config's {want}")

    ds = create_dataset(config)
    train_ds, valid_ds, test_ds = ds.build()
    model = get_model(config["model"])(config, train_ds, dev)
    if not model.factorized_eval:
        raise ValueError(
            f"{config['model']} has no factorized eval form")

    params = params_from_numpy(state["params"], dev)
    extras = params_from_numpy(state.get("extras") or {}, dev)
    with torch.inference_mode():
        user_table, item_table = model.propagate(params, model.consts, extras)
    user_table = user_table.float().cpu().numpy()
    item_table = item_table.float().cpu().numpy()

    splits = {"all": (train_ds, valid_ds, test_ds),
              "train+valid": (train_ds, valid_ds),
              "train": (train_ds,)}[mask_splits]
    users = np.concatenate([s.user_item_arrays()[0] for s in splits])
    items = np.concatenate([s.user_item_arrays()[1] for s in splits])
    order = np.argsort(users, kind="stable")
    hist_items = items[order].astype(np.int64)
    hist_indptr = np.searchsorted(users[order],
                                  np.arange(train_ds.n_users + 1))

    meta = {
        "version": ARTIFACT_VERSION,
        "model": str(config["model"]),
        "dataset": str(config["dataset"]),
        "n_users": int(train_ds.n_users),
        "n_items": int(train_ds.n_items),
        "dim": int(user_table.shape[1]),
        "mask_splits": mask_splits,
        "checkpoint": ckpt,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp = f"{out_path}.tmp.{os.getpid()}"
    writer = np.savez_compressed if compress else np.savez
    try:
        with open(tmp, "wb") as f:
            writer(
                f,
                user_table=user_table, item_table=item_table,
                hist_indptr=hist_indptr.astype(np.int64),
                hist_items=hist_items,
                # fixed-width unicode: the artifact loads without pickle
                user_tokens=np.asarray(
                    train_ds.field2id_token[train_ds.uid_field], dtype=str),
                item_tokens=np.asarray(
                    train_ds.field2id_token[train_ds.iid_field], dtype=str),
                meta=np.frombuffer(
                    json.dumps(meta).encode(), dtype=np.uint8),
            )
        os.replace(tmp, out_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out_path


# -- server -------------------------------------------------------------

class RecServer:
    """Standalone query server over an exported artifact.

    The tables live on ``device`` (default per :func:`resolve_device`);
    ``recommend`` is the single public call.  It keeps no per-call
    state, so concurrent calls (the threading HTTP server) need no lock.
    """

    def __init__(self, artifact_path: str,
                 device: torch.device | str | None = None):
        self.device = resolve_device(None, device)
        with np.load(artifact_path, allow_pickle=False) as z:
            self.meta = json.loads(bytes(z["meta"]).decode())
            if self.meta.get("version") != ARTIFACT_VERSION:
                raise ValueError(
                    f"artifact version {self.meta.get('version')} != "
                    f"{ARTIFACT_VERSION}")
            self.user_table = torch.from_numpy(z["user_table"]).to(self.device)
            self.item_table = torch.from_numpy(z["item_table"]).to(self.device)
            self._hist_indptr = z["hist_indptr"]
            self._hist_items = z["hist_items"]
            self.user_tokens = z["user_tokens"]
            self.item_tokens = z["item_tokens"]
        self.n_users, self.n_items = self.meta["n_users"], self.meta["n_items"]
        self._token2uid = {str(t): i for i, t in enumerate(self.user_tokens)}

    def resolve_users(self, users) -> np.ndarray:
        """External tokens (or ints matching tokens) → internal ids."""
        out = []
        for t in users:
            tok = str(t)
            if tok not in self._token2uid:
                raise KeyError(f"unknown user token {tok!r}")
            out.append(self._token2uid[tok])
        return np.asarray(out, dtype=np.int64)

    def _history_pairs(self, uids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(batch row, item id) of every history item of ``uids``."""
        starts = self._hist_indptr[uids]
        lens = self._hist_indptr[uids + 1] - starts
        rows = np.repeat(np.arange(len(uids)), lens)
        first = np.repeat(np.cumsum(lens) - lens, lens)
        pos = np.repeat(starts, lens) + (np.arange(int(lens.sum())) - first)
        return rows, self._hist_items[pos]

    def recommend(self, users, k: int = 10, mask_history: bool = True,
                  return_tokens: bool = True):
        """Top-``k`` items per user.

        ``users``: external tokens (the production interface).  Returns
        ``(items, scores)`` — items as token lists when
        ``return_tokens`` else internal id arrays.
        """
        uids = self.resolve_users(users)
        if len(uids) == 0:
            empty = np.zeros((0, k), dtype=np.float32)
            return ([] if return_tokens
                    else np.zeros((0, k), dtype=np.int64)), empty
        with torch.inference_mode():
            ue = self.user_table[torch.from_numpy(uids).to(self.device)]
            scores = ue @ self.item_table.T
            if mask_history:
                rows, items = self._history_pairs(uids)
                scores[torch.from_numpy(rows).to(self.device),
                       torch.from_numpy(items).to(self.device)] = NEG_INF
            scores[:, 0] = NEG_INF   # PAD item
            vals, idx = masked_topk(scores, k)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        if return_tokens:
            items = [[str(self.item_tokens[j]) for j in row] for row in idx]
            return items, vals
        return idx, vals


# -- minimal stdlib HTTP endpoint ----------------------------------------

def make_http_server(server: RecServer, host: str = "127.0.0.1",
                     port: int = 8080):
    """ThreadingHTTPServer wrapping ``server.recommend``.

    POST /recommend {"users": [...], "k": 10, "mask_history": true}
      → {"users": [...], "items": [[...]], "scores": [[...]]}
    GET /healthz → {"status": "ok", "model": ..., "n_items": ...}
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok",
                                 "model": server.meta["model"],
                                 "dataset": server.meta["dataset"],
                                 "n_users": server.n_users,
                                 "n_items": server.n_items})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/recommend":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                items, scores = server.recommend(
                    req["users"], k=int(req.get("k", 10)),
                    mask_history=bool(req.get("mask_history", True)))
                self._send(200, {"users": [str(u) for u in req["users"]],
                                 "items": items,
                                 "scores": [[float(v) for v in row]
                                            for row in scores]})
            except KeyError as e:
                self._send(400, {"error": f"unknown user or missing "
                                          f"field: {e}"})
            except Exception as e:   # serving endpoint: never crash
                self._send(500, {"error": str(e)})

        def log_message(self, *a):   # quiet by default
            pass

    return ThreadingHTTPServer((host, port), Handler)


# -- CLI ------------------------------------------------------------------

def main(argv=None):
    import argparse

    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.config.config import parse_cli

    ap = argparse.ArgumentParser(prog="recbole_gnn_tpu_torch.serve")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("export", help="export serving artifact")
    ex.add_argument("-m", "--model", required=True)
    ex.add_argument("-d", "--dataset", required=True)
    ex.add_argument("--config_files", nargs="*", default=None)
    ex.add_argument("--checkpoint", default=None)
    ex.add_argument("--out", required=True)
    ex.add_argument("--mask_splits",
                    choices=("all", "train+valid", "train"), default="all")
    ex.add_argument("--compress", action="store_true",
                    help="deflate the artifact (slow at web scale)")

    q = sub.add_parser("query", help="one-shot top-k query")
    q.add_argument("--artifact", required=True)
    q.add_argument("--users", nargs="+", required=True)
    q.add_argument("-k", type=int, default=10)

    h = sub.add_parser("http", help="serve over HTTP")
    h.add_argument("--artifact", required=True)
    h.add_argument("--host", default="127.0.0.1")
    h.add_argument("--port", type=int, default=8080)

    args, extra = ap.parse_known_args(argv)
    # --key=value overrides (run.py style); query/http read only
    # --use_gpu / --device from them
    params = parse_cli(extra)
    if args.cmd != "export" and set(params) - {"use_gpu", "device"}:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.cmd == "export":
        config = Config(model=args.model, dataset=args.dataset,
                        config_file_list=args.config_files,
                        config_dict=params)
        out = export_artifact(config, args.out,
                              checkpoint_path=args.checkpoint,
                              mask_splits=args.mask_splits,
                              compress=args.compress)
        print(f"wrote {out}")
        return
    srv = RecServer(args.artifact, device=resolve_device(params))
    if args.cmd == "query":
        items, scores = srv.recommend(args.users, k=args.k)
        for u, row, vs in zip(args.users, items, scores):
            pairs = ", ".join(f"{t}:{v:.3f}" for t, v in zip(row, vs))
            print(f"{u}: {pairs}")
    else:
        httpd = make_http_server(srv, args.host, args.port)
        print(f"serving {srv.meta['model']}/{srv.meta['dataset']} on "
              f"http://{args.host}:{args.port}")
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()


if __name__ == "__main__":
    main()
