"""The readings that a cell's limits are set from: the program's numbers
on many seeds, and on a few seeds the control's and each fault's.

    python3 -m portbench.calibrate --workload <cell> --seeds <n> ... \
        --control-seeds <n> ... [--seconds 3] --out <file.json>

The control is the plain reference put in the program's place and
computed in TF32 (the step below the configurations' float32 with TF32
off).  The faults are planted in the reference put in the program's
place: for a training cell, half of each batch left out with the mean
taken over the rest, and each validation answer replaced by the items
ranked just below it (an answer altered where it is produced); a step
that leaves the state unchanged reads 1 on ``change`` by its
definition.  For a serving cell
the fault is each answer's first item replaced by the item ranked just
below the answer.  Training cells need no measured window; a serving
cell runs a window of ``--seconds`` at its own rate for each seed.
The benchmark's own runs never run this.
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
from portbench.runners import common, serve, train  # noqa: E402
from portbench.reference.common import set_exact_matmul  # noqa: E402


def half_batches(batches: list) -> list:
    out = []
    for b in batches:
        b = dict(b)
        w = b["weight"].copy()
        w[len(w) // 2:] = 0.0
        b["weight"] = w
        out.append(b)
    return out


def train_readings(ctx, control: bool) -> dict:
    """The program's numbers on the set-up steps and a validation of
    their result; with ``control``, the control's and the faults'."""
    dev, cfg = ctx.device, ctx.cfg["port"]
    k = int(cfg["topk"][0])
    with common.Scratch() as root:
        s = train.Setup(ctx, root)
        s.trainer = s.model = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        log = ctx.reference.load_log(s.path, cfg, ctx.seed)
        r64 = ctx.reference.Reference(log, cfg, dev, "f64")
        ref = dict(zip(("losses", "grad1", "p_after"),
                       train.reference_steps(r64, s.p0, s.batches, dev)))
        _, n_rows, ref["valid"] = r64.validation(s.p_after, k,
                                                 tol=train.RANK_TIE)
        prog = {"losses": s.losses, "grad1": s.grad1, "p_after": s.p_after,
                "valid": s.valid0}
        out = {"program": train.compare(prog, ref, s.p0, n_rows)}
        out["program"]["batches"] = float(sum(r64.batch_faults(b)
                                              for b in s.batches))
        if not control:
            return out
        r32 = ctx.reference.Reference(log, cfg, dev, "tf32")
        c = dict(zip(("losses", "grad1", "p_after"),
                     train.reference_steps(r32, s.p0, s.batches, dev)))
        c["valid"] = r32.validation(s.p_after, k)[0]
        out["control"] = train.compare(c, ref, s.p0, n_rows)
        h = dict(zip(("losses", "grad1", "p_after"),
                     train.reference_steps(r64, s.p0, half_batches(s.batches),
                                           dev)))
        h["valid"] = s.valid0
        out["fault_half_batch"] = train.compare(h, ref, s.p0, n_rows)
        a = dict(ref, valid=None)
        a["valid"] = r64.validation(s.p_after, k, shift=True)[0]
        out["fault_answer"] = train.compare(a, ref, s.p0, n_rows)
        u = dict(ref, valid=s.valid0)
        u["p_after"] = s.p0
        out["fault_unchanged"] = train.compare(u, ref, s.p0, n_rows)
        return out


def served(R, params, reqs, k: int, shift: bool = False) -> list:
    """Answers in the server's form from a reference's own ranking;
    with ``shift``, each answer's first item replaced by the (k+1)-th."""
    scores = R.served_scores(params, reqs).double()
    vals, ids = torch.topk(scores, k + 1, dim=1)
    vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
    if shift:
        vals[:, 0], ids[:, 0] = vals[:, k], ids[:, k]
    vocab = R.log.item_vocab
    return [([[str(vocab[j]) for j in ids[r, :k]]], vals[r:r + 1, :k])
            for r in range(len(reqs))]


def serve_readings(ctx, control: bool) -> dict:
    rec = serve.run(ctx)
    out = {"program": dict(rec.checks),
           "p50_ms": float(np.median(rec.latency_ms)),
           "failed": rec.failed}
    if not control:
        return out
    k, dev, cfg = int(ctx.mix["k"]), ctx.device, ctx.cfg["port"]
    reqs, _ = rec.checked
    r64 = ctx.reference.Reference(rec.log, cfg, dev, "f64")
    r32 = ctx.reference.Reference(rec.log, cfg, dev, "tf32")
    out["control"] = serve.compare(r64, rec.params, reqs,
                                   served(r32, rec.params, reqs, k), k)
    out["fault_answer"] = serve.compare(
        r64, rec.params, reqs, served(r64, rec.params, reqs, k, True), k)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    set_exact_matmul()
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"),
              encoding="utf-8") as f:
        bench = json.load(f)
    cell = {c["name"]: c for c in bench["workloads"]}[args.workload]
    dev = torch.device("cuda", 0)
    results = {}
    for seed in list(dict.fromkeys(args.seeds + args.control_seeds)):
        t0 = time.perf_counter()
        ctx = runner.Context(bench, cell, seed, args.seconds, False, dev, t0)
        fn = train_readings if ctx.mix["runner"] == "train" else \
            serve_readings
        results[seed] = fn(ctx, seed in args.control_seeds)
        results[seed]["seconds"] = time.perf_counter() - t0
        print(json.dumps({str(seed): results[seed]}), flush=True)
    summary = {}
    for kind in ("program", "control", "fault_half_batch", "fault_answer",
                 "fault_unchanged"):
        rows = [r[kind] for r in results.values() if kind in r]
        if rows:
            pick = max if kind == "program" else min
            summary[kind] = {name: pick(r[name] for r in rows)
                             for name in rows[0]}
    print(json.dumps({"summary": summary, "device": harness.power_limit()}),
          flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump({"results": results, "summary": summary,
                   "device": harness.power_limit()}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
