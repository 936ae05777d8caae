"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration
(``portbench/configs/<config>.json``) and its traffic
(``portbench/traffic/<traffic>.json``, whose ``runner`` names the
module under ``portbench/runners/`` that runs it); its limits are in
``portbench/limits/<cell>.json`` and each metric's reader in
``portbench/metrics/<metric>.py``.  With ``--trace 0`` the result holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its
limit); the last lines of standard error repeat the checks.  Without a
card, or with fewer cards than the cell asks for, or with JAX or the
JAX package loaded once the window has closed, it prints no result and
exits with a code other than 0.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()   # before torch and the program load

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
if __package__ in (None, ""):    # run as a file: import from the checkout
    sys.path.insert(0, _ROOT)

# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(_ROOT, ".portbench_cache", _sub)
os.environ["USE_FLAX"] = "0"

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from
    ``/proc``; the module's import time where that cannot be read)."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return T_IMPORT


class Context:
    """What a runner is given: the cell's files, the run's arguments and
    the spans and tracer it records into."""

    def __init__(self, bench: dict, cell: dict, seed: int, seconds: float,
                 trace: bool, device: torch.device, t_start: float,
                 base: str = harness.PKG, overrides: dict | None = None):
        self.bench, self.cell, self.base = bench, cell, base
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.cfg = harness.load_json("configs", cell["config"], base)
        self.mix = harness.load_json("traffic", cell["traffic"], base)
        self.limits = harness.load_json("limits", cell["name"], base)
        for key, over in (overrides or {}).items():
            target = self.mix if key == "mix" else self.cfg[key]
            target.update(over)
        self.reference = harness.load_module("reference",
                                             self.cfg["reference"], base)
        self.spans = harness.Spans()
        self.tracer = (harness.Tracer(self.spans,
                                      float(self.mix["trace_at"]) * seconds,
                                      float(self.mix["trace_s"]), device)
                       if trace else None)


def span_summary(spans: dict) -> dict:
    """Per span: count, total seconds, and the 10th, 50th and 90th
    percentile in ms."""
    out = {}
    for name, v in spans.items():
        q = [round(harness.quantile(v, p) * 1e3, 4) for p in (.1, .5, .9)]
        out[name] = [len(v), round(sum(v), 4), *q]
    return out


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             base: str = harness.PKG, overrides: dict | None = None) -> dict:
    """Run the cell once and return its result (without the check for
    JAX, which the caller makes last)."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    cell = cells[workload]
    ctx = Context(bench, cell, seed, seconds, trace, device, t_start, base,
                  overrides)
    runner = harness.load_module("runners", ctx.mix["runner"], base)
    rec = runner.run(ctx)

    metrics, readers = {}, []
    on_card = device.type == "cuda"
    for m in bench["per_layer" if trace else "end_to_end"]:
        if not applies(m, workload):
            continue
        value = harness.load_module("metrics", m["name"], base).read(rec)
        if value is None:
            continue
        readers.append(m["name"])
        if on_card:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the limits file names the numbers compared; a reading it leaves
    # out (one with no upper reading, PERF.md) is shown, not compared
    checks = {}
    for name, limit in ctx.limits.items():
        value = rec.checks.get(name)
        value = None if value is None else harness.finite(value)
        checks[name] = {"value": value, "limit": limit,
                        "ok": value is not None and value <= limit}
    readings = {k: v for k, v in rec.checks.items() if k not in checks}
    correct = (rec.failed == 0 and bool(checks)
               and all(c["ok"] for c in checks.values()))
    dev = harness.device_description(device, int(cell["chips"]),
                                      rec.memory_peak_bytes)
    result = {"correct": correct, "attempted": rec.attempted,
              "failed": rec.failed, "metrics": metrics, "device": dev}
    if not on_card:
        # a host run: its numbers name no device metric, and of the
        # metrics only the names whose readers found something
        result["cpu_dry_run"] = {"setup_s": rec.setup_s,
                                 "window_s": rec.window_s,
                                 "readers": readers}
    if trace and rec.trace is not None and on_card:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        result["breakdown"] = {"device_ops": rec.trace["device_ops"],
                               "idle_gaps": rec.trace["idle_gaps"]}
    result["checks"] = checks
    diag = {"readings_not_compared": readings,
            "spans": span_summary(rec.spans),
            "spans_traced": span_summary(ctx.spans.traced),
            "work": rec.work,
            "tracer": ctx.tracer.log if ctx.tracer else None}
    print(f"portbench: {json.dumps(diag, default=float)}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(os.path.join(_ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    chips = {c["name"]: int(c["chips"]) for c in bench["workloads"]}
    need = chips.get(args.workload, 1)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"portbench: needs {need} CUDA device(s); found {have}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0),
                      process_start())
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX modules loaded in this process: {found}",
              file=sys.stderr)
        return 3
    print(f"portbench: {harness.power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
