"""Serving path: export a trained model to a standalone artifact, then
answer top-k recommendation queries from it.

Port of ``recbole_gnn_tpu/serve.py`` (``export_artifact``,
``RecServer``, ``SessionServer``, ``make_http_server`` and the
``export``/``query``/``http``/``session`` CLI verbs; the artifact's keys
and meta are the same, so each package's server reads the other's
artifacts).  A factorized model collapses at serving time to two dense
tables: propagate once, then every query is one (B, d) × (d, n_items)
product, the history and PAD mask, and an exact top-k.  A sequential
model scores sessions, so ``SessionServer`` rebuilds it from its
checkpoint and runs its forward per request batch.

Entry points run on the card unless the caller asks for the CPU
(``--use_gpu=False``, config ``use_gpu: False`` or ``device="cpu"``).

``RecServer(mesh_shape=)`` and ``--mesh_shape`` on ``query`` / ``http``
split the item table by rows over the ranks of the process group — over
``tp`` when the mesh has it, else over its first axis (``[n]`` → dp) —
padded with PAD rows to the shard multiple, and ``recommend`` runs the
item-sharded top-k (``parallel/topk.py``).  Every rank holds its block
and answers the same request: under ``query`` each rank runs the verb
and rank 0 prints; under ``http`` rank 0 binds the port and broadcasts
each request to the other ranks, which loop on it.  Launch one process
per rank (``torchrun --nproc_per_node=N -m recbole_gnn_tpu_torch.serve
query ... --mesh_shape=[N]``); a mesh of one needs no launcher.

CLI:
  python -m recbole_gnn_tpu_torch.serve export -m LightGCN -d ml-100k \
      [--config_files ...] [--checkpoint saved/LightGCN-ml-100k.ckpt] \
      --out /tmp/lightgcn.artifact.npz [--key=value ...]
  python -m recbole_gnn_tpu_torch.serve query --artifact /tmp/... \
      --users 196 186 22 -k 10 [--use_gpu=False]
  python -m recbole_gnn_tpu_torch.serve http --artifact /tmp/... --port 8080
      # POST /recommend {"users": ["196"], "k": 10}; GET /healthz
  python -m recbole_gnn_tpu_torch.serve session -m SRGNN -d diginetica \
      [--checkpoint saved/SRGNN-diginetica.ckpt] (--session 214 9 37 -k 10
      | --http 8080) [--key=value ...]
      # POST /recommend {"sessions": [["214", "9"]], "k": 10}
"""

from __future__ import annotations

import json
import math
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

from recbole_gnn_tpu_torch.data.session import (build_gcegnn_graphs,
                                                build_lessr_graphs,
                                                build_session_graphs,
                                                reverse_sessions)
from recbole_gnn_tpu_torch.models import get_model, model_info
from recbole_gnn_tpu_torch.ops.topk import NEG_INF, masked_topk
from recbole_gnn_tpu_torch.quick_start import (create_dataset,
                                               data_preparation,
                                               resolve_device)
from recbole_gnn_tpu_torch.eval.evaluator import to_device
from recbole_gnn_tpu_torch.parallel.launch import init_distributed
from recbole_gnn_tpu_torch.parallel.mesh import (axis_group, make_mesh,
                                                 mesh_axes, mesh_broadcast)
from recbole_gnn_tpu_torch.parallel.topk import (distributed_full_sort_topk,
                                                 item_shard)
from recbole_gnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   params_from_numpy)
from recbole_gnn_tpu_torch.utils.enums import ModelType

ARTIFACT_VERSION = 1


# -- export -------------------------------------------------------------

def _load_checkpoint_for(config, checkpoint_path: str | None
                         ) -> tuple[str, dict]:
    """(path, state) of the checkpoint to serve: ``checkpoint_path`` or
    the trainer's save path (``{checkpoint_dir}/{model}-{dataset}.ckpt``);
    its stored ``config.model``/``config.dataset`` must equal
    ``config``'s, so a stale checkpoint of another model is refused."""
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
            f"checkpoint {ckpt!r} was stored for {got}, not for the "
            f"serving config's {want}")
    return ckpt, state


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
            "sequential models score sessions, not user ids — serve them "
            "from their checkpoint with SessionServer (the session verb)")
    ckpt, state = _load_checkpoint_for(config, checkpoint_path)

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
    With ``mesh_shape`` this rank keeps its row block of the (padded)
    item table and ``recommend`` is a collective: every rank of the mesh
    calls it with the same request.
    """

    def __init__(self, artifact_path: str,
                 device: torch.device | str | None = None,
                 mesh_shape=None):
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
        self.mesh = self._group = None
        if mesh_shape:
            self.mesh = make_mesh(mesh_shape)
            # items shard over tp when the mesh has it, else over its
            # first axis (the list shorthand [n] → dp)
            names = self.mesh.mesh_dim_names
            self._group = axis_group(self.mesh,
                                     "tp" if "tp" in names else names[0])
            self.item_table = item_shard(self.item_table,
                                         self._group).clone()

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
            if self.mesh is not None:
                vals, idx = self._sharded_topk(ue, uids, k, mask_history)
                return self._result(vals.cpu().numpy(), idx.cpu().numpy(),
                                    return_tokens)
            scores = ue @ self.item_table.T
            if mask_history:
                rows, items = self._history_pairs(uids)
                scores[torch.from_numpy(rows).to(self.device),
                       torch.from_numpy(items).to(self.device)] = NEG_INF
            scores[:, 0] = NEG_INF   # PAD item
            vals, idx = masked_topk(scores, k)
        return self._result(vals.cpu().numpy(), idx.cpu().numpy(),
                            return_tokens)

    def _result(self, vals: np.ndarray, idx: np.ndarray, return_tokens: bool):
        if return_tokens:
            items = [[str(self.item_tokens[j]) for j in row] for row in idx]
            return items, vals
        return idx, vals

    def _sharded_topk(self, ue, uids, k, mask_history):
        """Item-sharded top-k over this rank's block: the history rows
        (0-padded) with a 0 column appended, so the PAD item is always
        excluded."""
        hist = np.zeros((len(uids), 1), np.int64)
        if mask_history:
            rows, items = self._history_pairs(uids)
            counts = np.bincount(rows, minlength=len(uids))
            hist = np.zeros((len(uids), int(counts.max(initial=0)) + 1),
                            np.int64)
            col = np.arange(len(rows)) - np.repeat(
                np.cumsum(counts) - counts, counts)
            hist[rows, col] = items
        return distributed_full_sort_topk(
            ue, self.item_table, torch.from_numpy(hist).to(self.device), k,
            self._group, n_valid_items=self.n_items)


class BroadcastRecServer:
    """Rank 0's face of a mesh :class:`RecServer` under ``http``: each
    request is resolved, then broadcast to every rank of the mesh (which
    run :func:`follow_requests`) before this rank's part of it; a lock
    keeps requests in one order across the threads of the HTTP
    server."""

    def __init__(self, server: RecServer):
        self.server = server
        self.meta, self.n_users, self.n_items = (
            server.meta, server.n_users, server.n_items)
        self._lock = threading.Lock()

    def recommend(self, users, k: int = 10, mask_history: bool = True,
                  return_tokens: bool = True):
        self.server.resolve_users(users)     # unknown tokens fail here
        with self._lock:
            mesh_broadcast((list(users), k, mask_history),
                           self.server.mesh)
            return self.server.recommend(users, k, mask_history,
                                         return_tokens)

    def close(self):
        """Release the other ranks from :func:`follow_requests`."""
        with self._lock:
            mesh_broadcast(None, self.server.mesh)


def follow_requests(server: RecServer) -> None:
    """A rank other than 0 under ``http``: answer each request rank 0
    broadcasts, until it broadcasts None."""
    while True:
        req = mesh_broadcast(None, server.mesh)
        if req is None:
            return
        users, k, mask_history = req
        server.recommend(users, k, mask_history)


# -- session serving ------------------------------------------------------

def _pad_to_bucket(n: int, buckets) -> int:
    """Next batch bucket ≥ n (beyond the last: round up to its
    multiple), so request shapes stay few."""
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]


# each servable dataset class's per-request graph builder
_GRAPH_BUILDERS = {
    "SequentialDataset": None,
    "SessionGraphDataset": build_session_graphs,
    "LESSRDataset": lambda s, n, L: build_lessr_graphs(s, n, L)[0],
    "GCEGNNDataset": lambda s, n, L: build_gcegnn_graphs(s, n, L)[0],
}


class SessionServer:
    """Real-time session-based recommendation from a checkpoint.

    Rebuilds the model once at startup (config → dataset for the vocab
    and shapes → model + params on ``device``, default per
    :func:`resolve_device`), then serves ad-hoc sessions: item-token
    lists → padded ``(B, L)`` arrays, padded to a batch bucket of
    1 / 8 / 64 / 256 (then multiples of 256) by repeating row 0, plus
    the session-graph arrays of the model's dataset class, built by the
    training path: ``build_session_graphs`` (SR-GNN family, the C++
    builder where it is available), ``build_lessr_graphs`` (LESSR) or
    ``build_gcegnn_graphs`` over the reversed sessions, which also
    become ``item_seq`` (GCE-GNN, trained on reversed sessions) →
    ``full_scores`` → the PAD column masked → exact top-k.  No history
    mask: the [recbole] sequential full-sort convention.  Tied scores
    may come back in another order than the JAX package's.

    A model with ``serving_calibrate`` (LESSR's BatchNorm) freezes its
    population statistics at startup from 1,024 training sessions
    spread over the training set by ``np.linspace``, as the JAX
    package does, so its scores do not depend on the batch.  LESSR's
    mailbox width is the request's own largest in-degree: the JAX
    package pads it to a power of 2 to bound its jit cache, and the
    padded slots count in no node, so the scores are the same.

    Serves every sequential model.  It keeps no per-request state (no
    per-(batch, k) cache), so the threading HTTP server's concurrent
    calls need no lock.
    """

    BATCH_BUCKETS = (1, 8, 64, 256)

    def __init__(self, config, checkpoint_path: str | None = None,
                 device: torch.device | str | None = None):
        self.device = resolve_device(config, device)
        if config["MODEL_TYPE"] != ModelType.SEQUENTIAL:
            raise ValueError("SessionServer serves sequential models; use "
                             "RecServer + export_artifact for general "
                             "models")
        info = model_info(config["model"])
        if info.dataset_class not in _GRAPH_BUILDERS:
            raise ValueError(
                f"{info.name} builds specialized per-session structures "
                f"({info.dataset_class}); serve it via the offline "
                "evaluator")
        self._dataset_class = info.dataset_class
        ckpt, state = _load_checkpoint_for(config, checkpoint_path)
        # data_preparation for the split cache (save_dataloaders): a
        # restart then skips augmentation and graph construction
        (_, train_ds), _, _ = data_preparation(config,
                                               create_dataset(config))
        self.model = get_model(config["model"])(config, train_ds,
                                                self.device)
        self.params = params_from_numpy(state["params"], self.device)
        self.extras = params_from_numpy(state.get("extras") or {},
                                        self.device)
        if hasattr(self.model, "serving_calibrate"):
            m = min(1024, train_ds.inter_num)
            rows = np.linspace(0, train_ds.inter_num - 1, m, dtype=np.int64)
            cb = {"item_seq": train_ds.inter[train_ds.item_list_field][rows],
                  "item_seq_len":
                  train_ds.inter[train_ds.item_length_field][rows]}
            for k, v in getattr(train_ds, "session_graphs", {}).items():
                cb[k] = v[rows]
            self.extras = self.model.serving_calibrate(
                self.params, self.model.consts, self.extras,
                to_device(cb, self.device))
        self.item_tokens = np.asarray(
            train_ds.field2id_token[train_ds.iid_field], dtype=str)
        self._tok2iid = {str(t): i for i, t in enumerate(self.item_tokens)}
        self.max_seq_len = int(train_ds.max_seq_len)
        self.n_items = int(train_ds.n_items)
        self.meta = {"model": str(config["model"]),
                     "dataset": str(config["dataset"]), "checkpoint": ckpt}

    def session_batch(self, sessions) -> tuple[dict, int]:
        """(numpy batch padded to its bucket, number of real rows) for
        item-token sessions, oldest first; only each session's last
        ``max_seq_len`` items are used, the training window."""
        n, L = len(sessions), self.max_seq_len
        seqs = np.zeros((n, L), dtype=np.int32)
        lens = np.zeros(n, dtype=np.int32)
        for r, s in enumerate(sessions):
            ids = []
            for t in s:
                if str(t) not in self._tok2iid:
                    raise KeyError(f"unknown item token {str(t)!r}")
                ids.append(self._tok2iid[str(t)])
            if not ids:
                raise KeyError("empty session")
            ids = ids[-L:]
            seqs[r, :len(ids)] = ids
            lens[r] = len(ids)
        b = _pad_to_bucket(n, self.BATCH_BUCKETS)
        if b > n:
            seqs = np.concatenate([seqs, np.repeat(seqs[:1], b - n, axis=0)])
            lens = np.concatenate([lens, np.repeat(lens[:1], b - n)])
        if self._dataset_class == "GCEGNNDataset":
            seqs = reverse_sessions(seqs, lens)
        batch = {"item_seq": seqs, "item_seq_len": lens}
        build = _GRAPH_BUILDERS[self._dataset_class]
        if build is not None:
            batch.update(build(seqs, lens, L))
        return batch, n

    def recommend(self, sessions, k: int = 10, return_tokens: bool = True):
        """Top-``k`` next items per session → ``(items, scores)``, items
        as token lists when ``return_tokens`` else internal id arrays."""
        if len(sessions) == 0:
            empty = np.zeros((0, k), dtype=np.float32)
            return ([] if return_tokens
                    else np.zeros((0, k), dtype=np.int64)), empty
        batch, n = self.session_batch(sessions)
        with torch.inference_mode():
            scores = self.model.full_scores(
                self.params, self.model.consts, self.extras,
                to_device(batch, self.device), None, False)
            scores[:, 0] = NEG_INF   # PAD item
            vals, idx = masked_topk(scores[:n], k)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        if return_tokens:
            items = [[str(self.item_tokens[j]) for j in row] for row in idx]
            return items, vals
        return idx, vals


# -- minimal stdlib HTTP endpoint ----------------------------------------

def make_http_server(server, host: str = "127.0.0.1", port: int = 8080):
    """ThreadingHTTPServer wrapping ``server.recommend``.

    RecServer:     POST /recommend {"users": [...], "k": 10,
                                    "mask_history": true}
    SessionServer: POST /recommend {"sessions": [[tok, ...], ...],
                                    "k": 10}
      → {"users" | "sessions": [...], "items": [[...]], "scores": [[...]]}
    GET /healthz → {"status": "ok", "model": ..., "n_items": ...}
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    is_session = isinstance(server, SessionServer)
    req_key = "sessions" if is_session else "users"

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
                                 "n_users": getattr(server, "n_users",
                                                    None),
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
                if is_session:
                    items, scores = server.recommend(
                        req[req_key], k=int(req.get("k", 10)))
                    echo = req[req_key]
                else:
                    items, scores = server.recommend(
                        req[req_key], k=int(req.get("k", 10)),
                        mask_history=bool(req.get("mask_history", True)))
                    echo = [str(u) for u in req[req_key]]
                self._send(200, {req_key: echo, "items": items,
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
    from recbole_gnn_tpu_torch.config.config import _coerce, parse_cli

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
    q.add_argument("--mesh_shape", type=_coerce, default=None)

    h = sub.add_parser("http", help="serve over HTTP")
    h.add_argument("--artifact", required=True)
    h.add_argument("--host", default="127.0.0.1")
    h.add_argument("--port", type=int, default=8080)
    h.add_argument("--mesh_shape", type=_coerce, default=None)

    se = sub.add_parser("session", help="session-based top-k from a "
                                        "checkpoint (sequential models)")
    se.add_argument("-m", "--model", required=True)
    se.add_argument("-d", "--dataset", required=True)
    se.add_argument("--config_files", nargs="*", default=None)
    se.add_argument("--checkpoint", default=None)
    se.add_argument("--session", nargs="+", default=None,
                    help="item tokens, oldest first (one-shot query)")
    se.add_argument("-k", type=int, default=10)
    se.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve over HTTP instead of a one-shot query")
    se.add_argument("--host", default="127.0.0.1")

    args, extra = ap.parse_known_args(argv)
    # --key=value overrides (run.py style); query/http read only
    # --use_gpu / --device from them
    params = parse_cli(extra)
    if args.cmd not in ("export", "session") and \
            set(params) - {"use_gpu", "device"}:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.cmd in ("export", "session"):
        config = Config(model=args.model, dataset=args.dataset,
                        config_file_list=args.config_files,
                        config_dict=params)
    if args.cmd == "export":
        out = export_artifact(config, args.out,
                              checkpoint_path=args.checkpoint,
                              mask_splits=args.mask_splits,
                              compress=args.compress)
        print(f"wrote {out}")
        return
    if args.cmd == "session":
        if args.http is None and not args.session:
            ap.error("session: pass --session tokens or --http PORT")
        srv = SessionServer(config, checkpoint_path=args.checkpoint)
        if args.http is None:
            items, scores = srv.recommend([args.session], k=args.k)
            pairs = ", ".join(f"{t}:{v:.3f}"
                              for t, v in zip(items[0], scores[0]))
            print(f"{' '.join(args.session)} -> {pairs}")
            return
        httpd = make_http_server(srv, args.host, args.http)
        print(f"serving sessions for {srv.meta['model']}/"
              f"{srv.meta['dataset']} on http://{args.host}:{args.http}")
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
        return
    use_gpu = params.get("use_gpu") is not False
    _join_mesh(args.cmd, args.mesh_shape, use_gpu)
    srv = RecServer(args.artifact, device=resolve_device(params),
                    mesh_shape=args.mesh_shape)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    if args.cmd == "query":
        items, scores = srv.recommend(args.users, k=args.k)
        if lead:
            for u, row, vs in zip(args.users, items, scores):
                pairs = ", ".join(f"{t}:{v:.3f}" for t, v in zip(row, vs))
                print(f"{u}: {pairs}")
    elif srv.mesh is not None and dist.is_initialized() and not lead:
        follow_requests(srv)
    else:
        front = (BroadcastRecServer(srv) if srv.mesh is not None
                 and dist.is_initialized() else srv)
        httpd = make_http_server(front, args.host, args.port)
        print(f"serving {srv.meta['model']}/{srv.meta['dataset']} on "
              f"http://{args.host}:{args.port}")
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
            if front is not srv:
                front.close()


def _join_mesh(cmd: str, mesh_shape, use_gpu: bool) -> None:
    """A mesh of more than one rank serves from a process group: join
    ``torchrun``'s (its environment) unless the caller has one; without
    either, say how to launch."""
    n = math.prod(mesh_axes(mesh_shape, 1).values()) if mesh_shape else 1
    if n == 1 or dist.is_initialized():
        return
    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            f"--mesh_shape={mesh_shape} spans {n} ranks: launch one process "
            f"per rank, e.g. torchrun --nproc_per_node={n} -m "
            f"recbole_gnn_tpu_torch.serve {cmd} ... --mesh_shape="
            f"{mesh_shape}")
    init_distributed(use_gpu=use_gpu)


if __name__ == "__main__":
    main()
