"""Top-k requests to the program's server, arriving in an open loop at
the traffic's fixed rate.

Set-up writes the configuration's log, reads it with the reference's
reader (for the requests and the weights' shapes), writes a checkpoint
of the benchmark's weights and builds the server from it through the
program's own entry (``export_artifact`` and ``RecServer`` for a
factorized model, ``SessionServer`` for a session model; the
configuration's ``server`` names which), then warms it with requests
drawn apart from the window's.  The served model, the window's
requests and its Poisson arrival gaps over ``--seconds`` are one fixed
set drawn with the traffic's ``set_seed``, served in an order drawn
from the run's seed: the weights changed the cost of a request (its
top-k) enough to move the tails between seeds.  One thread serves the
requests in order of arrival, each as soon as it is due and the
previous one is answered.  A request's latency runs from when it
was due to when its answer is on the host, so it holds its wait in the
queue.  Afterwards the reference scores a sample of the requests,
drawn from the seed with the longest in it; a request that fails
counts in ``failed``.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from portbench import harness
from portbench.runners import common

ARRIVALS, REQUESTS, WARMUP, SAMPLE, ORDER = 1, 2, 3, 4, 5


class Server:
    """The program's server for the configuration, built in set-up."""

    def __init__(self, ctx, root: str, log):
        from recbole_gnn_tpu_torch.train.checkpoint import save_checkpoint
        dev = ctx.device
        config = common.port_config(ctx, root)
        self.kind = ctx.cfg["server"]
        shp = ctx.reference.param_shapes(log, ctx.cfg["port"])
        params = common.benchmark_params(ctx, None, shp,
                                         seed=int(ctx.mix["set_seed"]))
        self.params = common.host(params)
        ckpt = os.path.join(root, "bench.ckpt")
        save_checkpoint(ckpt, {
            "params": harness.tree(params), "extras": {},
            "epoch": np.int64(0), "best_score": np.float64(np.nan),
            "best_epoch": np.int64(-1),
            "config": {"model": config["model"],
                       "dataset": config["dataset"]}})
        del params
        if self.kind == "session":
            from recbole_gnn_tpu_torch.serve import SessionServer
            self.server = SessionServer(config, ckpt, device=dev)
        else:
            from recbole_gnn_tpu_torch.serve import (RecServer,
                                                     export_artifact)
            art = export_artifact(config, os.path.join(root, "bench.npz"),
                                  ckpt, device=dev)
            self.server = RecServer(art, device=dev)

    def __call__(self, request, k: int):
        """(items, scores) of one request: a user token or a session."""
        return self.server.recommend([request], k)


def requests(log, kind: str, n: int, rng: np.random.Generator) -> list:
    """``n`` requests drawn from the log: a user token in proportion to
    the user's interactions, or a session's clicks up to a click drawn
    uniformly over all clicks after each session's first (item tokens,
    oldest first)."""
    if kind == "session":
        rows = np.flatnonzero(log.click_pos >= 1)
        picks = rows[rng.integers(0, len(rows), n)]
        return [log.item_vocab[log.clicks[log.click_start[p]:p]].tolist()
                for p in picks]
    return log.user_tok[rng.integers(0, len(log.user_tok), n)].tolist()


def warm(srv: Server, log, ctx) -> None:
    """Serve the warm-up requests, drawn apart from the window's."""
    for r in requests(log, srv.kind, int(ctx.mix["warmup_requests"]),
                      common.draw(ctx.seed, WARMUP)):
        srv(r, int(ctx.mix["k"]))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def schedule(ctx, log, kind: str, rate: float, seconds: float):
    """(due times from the window's start, requests): a fixed set of
    exponential gaps at ``rate`` over ``seconds`` and a fixed set of
    requests, both drawn with the traffic's ``set_seed``, each in an
    order drawn from the run's seed.  Every seed serves the same work;
    only its order differs."""
    n = max(1, int(rate * seconds))
    fixed = int(ctx.mix["set_seed"])
    gaps = common.draw(fixed, ARRIVALS).exponential(1.0 / rate, n)
    reqs = requests(log, kind, n, common.draw(fixed, REQUESTS))
    order = common.draw(ctx.seed, ORDER)
    gaps = gaps[order.permutation(n)]
    return np.cumsum(gaps), [reqs[i] for i in order.permutation(n)]


def window(ctx, srv: Server, due, reqs, spans: harness.Spans,
           tracer=None, keep=frozenset()) -> dict:
    """The open loop: each request served by this thread in order, as
    soon as it is due and the one before it is answered; latency from
    its due time.  Only the answers of the requests in ``keep`` (the
    check's sample) are kept, so the loop makes no garbage of its
    own."""
    k = int(ctx.mix["k"])
    n = len(reqs)
    answers, failed = {}, 0
    latency = np.zeros(n)
    t0 = time.perf_counter()
    if tracer is not None:
        tracer.begin(t0)
    for i in range(n):
        at = t0 + due[i]
        if tracer is not None:
            tracer.poll()
        now = time.perf_counter()
        if now < at:
            with spans.span("wait"):
                if at - now > 2e-3:
                    time.sleep(at - now - 1e-3)
                while time.perf_counter() < at:
                    pass
        with spans.span("recommend"):
            try:
                answer = srv(reqs[i], k)
            except Exception:   # noqa: BLE001 — counted as failed
                failed += 1
                answer = None
        latency[i] = time.perf_counter() - at
        if i in keep and answer is not None:
            answers[i] = answer
    window_s = time.perf_counter() - t0
    if tracer is not None:
        tracer.stop()
    return {"window_s": window_s, "n": n, "failed": failed,
            "latency_ms": latency * 1e3, "answers": answers}


def run(ctx) -> harness.Record:
    dev = ctx.device
    with common.Scratch() as root:
        path = common.write_data(ctx, root)
        log = ctx.reference.load_log(path, ctx.cfg["port"], ctx.seed)
        srv = Server(ctx, root, log)
        warm(srv, log, ctx)
        rate = float(ctx.mix["rate_per_s"])
        due, reqs = schedule(ctx, log, srv.kind, rate, ctx.seconds)
        keep = set(sample(reqs, ctx, log, srv.kind))
        if ctx.tracer is not None:
            ctx.tracer.prepare()
        setup_s = time.perf_counter() - ctx.t_start
        w = window(ctx, srv, due, reqs, ctx.spans, ctx.tracer, keep)
        peak = harness.memory_peak(dev)
        trace = ctx.tracer.summary() if ctx.tracer is not None else None
        srv.server = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        R = ctx.reference.Reference(log, ctx.cfg["port"], dev, "f64")
        idx = sorted(w["answers"])
        checked = ([reqs[i] for i in idx], [w["answers"][i] for i in idx])
        checks = compare(R, srv.params, *checked, int(ctx.mix["k"]))
    return harness.Record(
        setup_s=setup_s, window_s=w["window_s"], attempted=w["n"],
        failed=w["failed"],
        work={"requests": w["n"], "rate_per_s": rate,
              "held_s": ctx.tracer.held_s if ctx.tracer else 0.0},
        latency_ms=w["latency_ms"].tolist(), spans=dict(ctx.spans.durations),
        trace=trace, shapes={}, checks=checks, cfg=ctx.cfg, device=dev,
        memory_peak_bytes=peak, base=ctx.base, reference=ctx.reference,
        log=log, params=srv.params, checked=checked)


def sample(reqs: list, ctx, log, kind: str) -> list[int]:
    """Indices of the requests whose answers are checked: the traffic's
    ``check_requests`` drawn from the seed, and the longest request (the
    longest history, or the longest session) among them."""
    m = min(int(ctx.mix["check_requests"]), len(reqs))
    chosen = common.draw(ctx.seed, SAMPLE).choice(len(reqs), m,
                                                  replace=False).tolist()
    if kind == "session":
        size = [len(r) for r in reqs]
    else:
        toks, counts = np.unique(log.user_tok, return_counts=True)
        size = counts[np.searchsorted(toks, np.asarray(reqs))]
    longest = int(np.argmax(size))
    return chosen if longest in chosen else chosen + [longest]


def gaps(ref_scores: torch.Tensor, served_ids: np.ndarray,
         served_vals: np.ndarray, k: int) -> tuple[float, float]:
    """(rank, score) gaps of the served answers against the reference's
    scores: how far each served item's score lies below the reference's
    score at its rank, and how far each served score lies from the
    reference's score of that item, both over the request's largest
    finite score magnitude; an unknown or masked item reads inf."""
    s = ref_scores.double().cpu()
    best = torch.topk(s, k, dim=1).values
    rank = score = 0.0
    for r in range(s.shape[0]):
        row = s[r]
        fin = row[torch.isfinite(row)]
        scale = max(float(fin.abs().max()), 1e-30)
        ids = served_ids[r]
        if (ids < 0).any() or len(ids) != k:
            return float("inf"), float("inf")
        got = row[torch.from_numpy(ids)]
        rank = max(rank, float((best[r] - got).max()) / scale)
        score = max(score, float((torch.from_numpy(
            np.asarray(served_vals[r], np.float64)) - got).abs().max())
            / scale)
    return rank, score


def compare(R, params: dict, reqs: list, answers: list, k: int) -> dict:
    if not reqs:
        return {"rank": float("inf"), "score": float("inf")}
    scores = R.served_scores(params, reqs)
    ids = np.stack([R.item_ids(a[0][0]) for a in answers])
    vals = np.stack([np.asarray(a[1][0]) for a in answers])
    rank, score = gaps(scores, ids, vals, k)
    return {"rank": rank, "score": score}
