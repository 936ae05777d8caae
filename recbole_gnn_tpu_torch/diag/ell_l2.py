"""K2 (``ell_spmm``, the bucketed-ELL SpMM) at the LightGCN slice shape in
four L2 states, on the card.

    python -m recbole_gnn_tpu_torch.diag.ell_l2 [--steps 10]
        [--variants] [--baseline-src PATH] [--out FILE]

Builds the graph ``chip_smoke.py`` trains on (the Gowalla-shape log of
:mod:`~recbole_gnn_tpu_torch.diag.gowalla_shape`; LightGCN, 64 wide, 3
layers, ``sparse_spmm_impl: ell``) and runs K2 (over ``graph.ell``, on
the embedding table) and K2ᵀ (over ``graph.rev_ell``, on a cotangent)
in four states of the L2:

1. ``warm_reused``: 20 calls back to back, each result dropped at once,
   so the allocator hands every call the block the last one freed;
2. ``warm_fresh``: 20 calls, each result kept alive, as autograd keeps
   every layer's output;
3. ``flushed``: a 256 MB write before each call (``timing.time_ms``:
   the whole call by CUDA events, median of 25; and by kernel);
4. ``in_step``: LightGCN training steps (2,048 pairs) under
   ``torch.profiler`` (K2 and K2ᵀ together: one kernel).

Every state gives device µs per call by pass (row pass, combine pass)
from ``torch.profiler``: each pass's time over the records the profiler
kept of it (one per call; a long process may lose some).
``nvidia-smi`` samples the SM and memory clocks and the power draw
during a sustained second of state 1 and of state 4.

``--variants`` also builds each entry of :data:`VARIANTS` (the kernel's
source with one design element taken out or one parameter changed, by
exact text replacement) and measures it the same way, in turns with the
kernel as it is (kernel, variants, variants reversed, kernel), so an
element's effect is read within one call.  ``--baseline-src``
(repeatable) adds another source of the kernel with the same C
interface, built and measured in the same turns.  Prints one JSON
object per kernel and turn, and with ``--out`` writes them all to that
file.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import re
import subprocess
import tempfile
import time

import numpy as np
import torch

from recbole_gnn_tpu_torch.diag.timing import kernel_records, resolve, time_ms
from recbole_gnn_tpu_torch.ops import cuda_build
from recbole_gnn_tpu_torch.ops import ell_spmm as t_ell

SEED = 2020
REPS = 20
ROW_KERNEL, COMBINE_KERNEL = "ell_row_kernel", "ell_combine_kernel"

# each variant: the kernel's source with one design element taken out or
# one parameter changed, as (text, replacement) pairs that must each
# match exactly once
VARIANTS: dict[str, list[tuple[str, str]]] = {
    # the row pass's registers left to the compiler (two blocks per SM)
    "blocks_free": [("constexpr int kRowBlocksPerSM = 3;",
                     "constexpr int kRowBlocksPerSM = 1;")],
    # the slot streams and the outputs through the default cache policy
    "no_stream_hints": [
        ("    int32_t ci = sub < n ? __ldcs(idx + a + sub) : 0;",
         "    int32_t ci = sub < n ? __ldg(idx + a + sub) : 0;"),
        ("slot_weight<T>(__ldcs(w + a + sub))",
         "slot_weight<T>(__ldg(w + a + sub))"),
        ("      const int32_t ni = nx < n ? __ldcs(idx + a + nx) : 0;",
         "      const int32_t ni = nx < n ? __ldg(idx + a + nx) : 0;"),
        ("slot_weight<T>(__ldcs(w + a + nx))",
         "slot_weight<T>(__ldg(w + a + nx))"),
        ("              const int t = __ldcs(rdst + row);",
         "              const int t = __ldg(rdst + row);"),
        ("constexpr bool kStreamStores = true;",
         "constexpr bool kStreamStores = false;")],
    # the combine pass with 4 workspace rows in flight, not 16
    "combine4": [("constexpr int kCombineUnroll = 16;",
                  "constexpr int kCombineUnroll = 4;")],
}


# -- set-up ---------------------------------------------------------------

def slice_setup(tmp: str, dev: torch.device, n_batches: int = 40,
                shape: dict | None = None) -> dict:
    """The slice's LightGCN on ``ell``: model, trainer, fresh parameters
    and optimizer state, ``n_batches`` host batches, the graph, the
    embedding table x and a cotangent.  ``shape`` (the keyword arguments
    of ``write_gowalla_shape``) defaults to the Gowalla shape."""
    from recbole_gnn_tpu_torch.config import Config
    from recbole_gnn_tpu_torch.diag.gowalla_shape import (
        GOWALLA_SHAPE, write_gowalla_shape)
    from recbole_gnn_tpu_torch.models import get_model
    from recbole_gnn_tpu_torch.quick_start import (create_dataset,
                                                   data_preparation)
    from recbole_gnn_tpu_torch.train.trainer import Trainer
    write_gowalla_shape(tmp, "gowalla_shape", SEED,
                        **(shape or GOWALLA_SHAPE))
    config = Config(model="LightGCN", dataset="gowalla_shape", config_dict={
        "data_path": tmp, "checkpoint_dir": os.path.join(tmp, "ck"),
        "embedding_size": 64, "n_layers": 3, "enable_sparse": True,
        "sparse_spmm_impl": "ell", "seed": SEED, "state": "ERROR"})
    (train_loader, train_ds), _, _ = data_preparation(
        config, create_dataset(config))
    model = get_model("LightGCN")(config, train_ds, dev)
    trainer = Trainer(config, model)
    gen = torch.Generator().manual_seed(SEED)
    params = model.init_params(gen)
    for p in params.values():
        p.requires_grad_(True)
    opt_state = trainer.optimizer.init(params)
    it = iter(train_loader)
    graph = model.consts["graph"]
    x = torch.cat([params["user_emb"], params["item_emb"]]).detach()
    cot = torch.randn(graph.n_nodes, x.shape[1], device=dev,
                      generator=torch.Generator(device=dev).manual_seed(SEED))
    return {"model": model, "trainer": trainer, "params": params,
            "rng": torch.Generator().manual_seed(SEED),
            "opt_state": opt_state, "graph": graph, "x": x.contiguous(),
            "cot": cot, "batches": [next(it) for _ in range(n_batches)]}


def layout_stats(meta) -> dict:
    """Per bucket: width, virtual rows, slots and real slots."""
    real = [int(v.sum()) for v in meta.vlens]
    return {"ks": list(meta.ks), "rows": list(meta.rows),
            "slots": [k * n for k, n in zip(meta.ks, meta.rows)],
            "real_slots": real, "e_pad": meta.e_padded,
            "n_edges": sum(real), "n_vrows": meta.n_vrows,
            "split_nodes": meta.n_multi, "split_vrows": meta.n_multi_vrows}


# -- kernels under test ------------------------------------------------------

def _build_source(name: str, text: str, build_dir: str) -> tuple[str, str]:
    """(source path, library path) of ``text`` written into
    ``build_dir``."""
    os.makedirs(build_dir, exist_ok=True)
    digest = hashlib.sha256(text.encode()).hexdigest()[:12]
    stem = re.sub(r"\W", "_", name)
    src = os.path.join(build_dir, f"{stem}-{digest}.cu")
    lib = os.path.join(build_dir, f"lib{stem}-{digest}.so")
    with open(src, "w") as f:
        f.write(text)
    return src, lib


def print_ptxas(name: str, log: str):
    """Registers and spills of each kernel in an ``-Xptxas=-v`` log."""
    fn = "?"
    for line in log.splitlines():
        m = re.search(r"entry function '\w*?(ell_\w+?_kernel)I(\w+?)Li(\d)E",
                      line)
        if m:
            fn = f"{m.group(1)}<{m.group(2)}, {m.group(3)}>"
        elif "registers" in line or "spill" in line:
            print(f"  {name} {fn}: {line.split(':', 1)[-1].strip()}",
                  flush=True)


def build_all(sources: dict[str, str], build_dir: str) -> dict:
    """Compile each ``{name: source text}`` at once (one ``nvcc`` each,
    ``csrc/`` on the include path for its headers); returns ``{name:
    ctypes.CDLL}``."""
    procs = {}
    for name, text in sources.items():
        src, lib = _build_source(name, text, build_dir)
        procs[name] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             cuda_build.CSRC_DIR, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        print_ptxas(name, log)
        libs[name] = ctypes.CDLL(lib)
    return libs


def variant_source(name: str) -> str:
    with open(os.path.join(cuda_build.CSRC_DIR, "ell_spmm.cu")) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} matches "
                             f"{text.count(old)} times in ell_spmm.cu")
        text = text.replace(old, new)
    return text


@contextlib.contextmanager
def library(lib: ctypes.CDLL):
    """The wrapper launches ``lib`` (same C interface) inside."""
    saved = cuda_build._loaded.get("ell_spmm")
    cuda_build._loaded["ell_spmm"] = lib
    try:
        yield
    finally:
        cuda_build._loaded["ell_spmm"] = saved


# -- the four states -------------------------------------------------------

def _k2_split(prof, calls: int) -> dict:
    """µs per call of each pass: its time over the records the profiler
    kept (it may drop some of a long run's records, so not over
    ``calls``; each call runs each pass once)."""
    total, records = kernel_records(prof)
    row_us, comb_us = (total.get(k, 0.0) / max(records.get(k, 0), 1)
                       for k in (ROW_KERNEL, COMBINE_KERNEL))
    return {"row_us": row_us, "combine_us": comb_us, "us": row_us + comb_us,
            "calls": calls, "row_records": records.get(ROW_KERNEL, 0)}


def warm_us(fn, keep: bool, reps: int = REPS) -> dict:
    """Device µs per call by pass, ``reps`` calls after one warm-up; with
    ``keep`` every result stays alive until the last call ends."""
    fn()
    torch.cuda.synchronize()
    kept = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if keep:
                kept.append(fn())
            else:
                fn()
        torch.cuda.synchronize()
    del kept
    return _k2_split(prof, reps)


def flushed(fn, dev, reps: int = REPS) -> dict:
    """The whole call by CUDA events (``timing.time_ms``: L2 flushed and
    the card kept busy before each launch), and by pass from the
    profiler with the same flush before each call."""
    ms = time_ms(fn, dev)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return dict(_k2_split(prof, reps), call_ms=ms)


def _step(s: dict, b, dev):
    from recbole_gnn_tpu_torch.eval.evaluator import to_device
    s["trainer"].train_step(s["params"], s["opt_state"], s["model"].consts,
                            {}, to_device(b, dev), s["rng"])


def in_step(s: dict, dev, steps: int) -> dict:
    """The K2 passes' device µs per launch inside LightGCN training
    steps (5 warm-up steps, then ``steps`` under the profiler), beside
    the wrapper's own count of launches over the window and the step's
    device and wall time."""
    batches = s["batches"]
    for b in batches[:5]:
        _step(s, b, dev)
    torch.cuda.synchronize()
    before = t_ell.ell_spmm.launches
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            _step(s, batches[5 + i % (len(batches) - 5)], dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = t_ell.ell_spmm.launches - before
    out = _k2_split(prof, launches)
    out.update(launches=launches, steps=steps,
               step_device_ms=sum(kernel_records(prof)[0].values())
               / steps / 1e3,
               step_wall_ms=wall / steps * 1e3)
    return out


def clocks_during(fn, seconds: float = 1.0) -> dict:
    """``nvidia-smi`` every 100 ms while ``fn`` runs again and again for
    ``seconds``: median SM and memory clock (MHz) and power draw (W)."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.3)
        t0 = time.perf_counter()
        calls = 0
        while time.perf_counter() - t0 < seconds:
            fn()
            calls += 1
        torch.cuda.synchronize()
    finally:
        proc.terminate()
        text = proc.communicate(timeout=10)[0]
    rows = []
    for line in text.splitlines():
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    if not rows:
        return {"samples": 0}
    a = np.array(rows)
    return {"samples": len(rows), "calls": calls,
            "sm_mhz": float(np.median(a[:, 0])),
            "mem_mhz": float(np.median(a[:, 1])),
            "power_w": float(np.median(a[:, 2]))}


def measure(s: dict, dev, steps: int, clocks: bool = False) -> dict:
    """The four states for K2 and K2ᵀ (the in-step state once: both
    run in every step)."""
    g, x, cot = s["graph"], s["x"], s["cot"]
    with torch.inference_mode():
        runs = {"K2": lambda: t_ell.ell_spmm(g.ell, x),
                "K2T": lambda: t_ell.ell_spmm_transpose(g.rev_ell, cot)}
        out = {kind: {"warm_reused": warm_us(fn, False),
                      "warm_fresh": warm_us(fn, True),
                      "flushed": flushed(fn, dev)}
               for kind, fn in runs.items()}
        if clocks:
            out["clocks_warm_reused"] = clocks_during(runs["K2"])
    out["in_step"] = in_step(s, dev, steps)
    if clocks:
        i = [0]

        def one_step():
            _step(s, s["batches"][5 + i[0] % (len(s["batches"]) - 5)], dev)
            i[0] += 1
        out["clocks_in_step"] = clocks_during(one_step)
    return out


def check(s: dict) -> float:
    """K2 and K2ᵀ against both plain versions (the JAX composition and
    the pad-free sums), |err| ≤ 1e-4 · Σ|terms|; returns the largest
    |err|."""
    from recbole_gnn_tpu_torch.ops.segment_spmm import spmm_coo
    g, err = s["graph"], 0.0
    with torch.inference_mode():
        for meta, inp, coo, n_out, fn in (
                (g.ell, s["x"], (g.src, g.dst, g.weight), g.n_nodes,
                 t_ell.ell_spmm),
                (g.rev_ell, s["cot"], (g.rev_src, g.rev_dst, g.rev_weight),
                 g.n_src_nodes, t_ell.ell_spmm_transpose)):
            got = fn(meta, inp)
            src, dst, w = coo
            abssum = spmm_coo(src, dst, w.abs(), inp.abs(), n_out)
            for plain in (t_ell.ell_spmm_plain, t_ell.ell_spmm_pad_free_plain):
                e = (got - plain(meta, inp)).abs()
                if not bool((e <= 1e-4 * abssum).all()):
                    raise AssertionError(
                        f"ell_spmm disagrees with {plain.__name__}: max "
                        f"|err| {float(e.max())}")
                err = max(err, float(e.max()))
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--baseline-src", action="append", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    dev = resolve("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(torch.cuda.get_device_properties(dev), flush=True)
    print_ptxas("kernel", cuda_build.build(["ell_spmm"]).get("ell_spmm", ""))
    kernels = {"kernel": contextlib.nullcontext}
    with tempfile.TemporaryDirectory(prefix="ell_l2_") as tmp:
        sources = {n: variant_source(n) for n in
                   (VARIANTS if args.variants else ())}
        for path in args.baseline_src:
            with open(path) as f:
                sources["baseline:" + os.path.basename(path)] = f.read()
        libs = build_all(sources, os.path.join(tmp, "build"))
        for name, lib in libs.items():
            kernels[name] = lambda lib=lib: library(lib)
        t0 = time.perf_counter()
        s = slice_setup(tmp, dev)
        print(json.dumps({"setup_s": time.perf_counter() - t0,
                          "ell": layout_stats(s["graph"].ell),
                          "rev_ell": layout_stats(s["graph"].rev_ell)}),
              flush=True)
        order = list(kernels) + list(kernels)[::-1]
        results = []
        for turn, name in enumerate(order):
            with kernels[name]():
                r = {"kernel": name, "turn": turn,
                     "max_abs_err": check(s),
                     **measure(s, dev, args.steps, clocks=turn == 0)}
            print(json.dumps(r), flush=True)
            results.append(r)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
