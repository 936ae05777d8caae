"""Find the highest request rate a serving cell sustains without a
growing backlog: a stepped open-loop sweep, the server built once.

    python3 -m portbench.sweep --workload <cell> --rates 500 1000 ... \
        [--seconds 8] [--seed <n>] [--out <file.json>]

At each rate the cell's traffic runs for ``--seconds`` (fresh arrivals
and requests from the seed).  A rate is sustained when the mean queue
wait of the window's last quarter of requests is at most twice that of
its first quarter plus two median service times (a backlog that grows
through the window fails it), and the mean queue wait over the window
is at most one median service time (a queue that keeps requests
waiting longer than they are served fails it: near that load the tail
swings with every small change of the host's speed).  The cell's
traffic file takes four fifths of the highest sustained rate as its
``rate_per_s``; the table goes into ``PERF.md``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import harness  # noqa: E402
from portbench import run as runner  # noqa: E402
from portbench.runners import common, serve  # noqa: E402


def step(ctx, srv, log, rate: float, seconds: float) -> dict:
    spans = harness.Spans()
    due, reqs = serve.schedule(ctx, log, srv.kind, rate, seconds)
    w = serve.window(ctx, srv, due, reqs, spans)
    lat = w["latency_ms"]
    service = np.asarray(spans.durations["recommend"]) * 1e3
    wait = lat - service
    q = max(1, len(lat) // 4)
    first, last = float(wait[:q].mean()), float(wait[-q:].mean())
    med = float(np.median(service))
    mean = float(wait.mean())
    return {"rate_per_s": rate, "requests": w["n"], "failed": w["failed"],
            "p50_ms": float(np.median(lat)),
            "p95_ms": float(np.quantile(lat, 0.95)),
            "service_p50_ms": med,
            "wait_first_quarter_ms": first, "wait_last_quarter_ms": last,
            "window_s": w["window_s"],
            "wait_mean_ms": mean,
            "sustained": bool(last <= 2 * first + 2 * med and mean <= med)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"),
              encoding="utf-8") as f:
        bench = json.load(f)
    cell = {c["name"]: c for c in bench["workloads"]}[args.workload]
    ctx = runner.Context(bench, cell, args.seed, args.seconds, False,
                         torch.device("cuda", 0), time.perf_counter())
    rows = []
    with common.Scratch() as root:
        path = common.write_data(ctx, root)
        log = ctx.reference.load_log(path, ctx.cfg["port"], ctx.seed)
        srv = serve.Server(ctx, root, log)
        serve.warm(srv, log, ctx)
        for rate in args.rates:
            rows.append(step(ctx, srv, log, rate, args.seconds))
            print(json.dumps(rows[-1]), flush=True)
    ok = [r["rate_per_s"] for r in rows if r["sustained"]]
    out = {"workload": args.workload, "rows": rows,
           "highest_sustained": max(ok) if ok else None,
           "device": harness.power_limit()}
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}),
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
