"""D1 probe: the block segment sum at the TPU floor probe's shape.

H100 counterpart of ``scripts/diag/pallas_floor.py`` (K1's body
without its gather, in three modes).  The same inputs, made from numpy
``default_rng(0)``: N = 9,671 nodes, E = 2M random edges padded with
``pad_edges`` to 2,007,040, D = 64, messages ``x[src]·w`` in f32.  No
lane padding to 128: that was the TPU's tiling, not the function.

    python -m recbole_gnn_tpu_torch.diag.pallas_floor [--device cpu]

Prints, per mode (``f32``, ``bf16``, ``hilo``, ``stream``), the kernel's
time, the plain version's, the bound, and the kernel's largest
difference from the plain version; ``index_add_`` is timed beside
``f32`` as the one-call yardstick.  On the CPU only the plain versions
run, on the host clock.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from recbole_gnn_tpu_torch.diag.timing import (bound_by, bound_ms, resolve,
                                               time_ms)
from recbole_gnn_tpu_torch.ops.segment_spmm import build_rowptr, pad_edges
from recbole_gnn_tpu_torch.ops.segment_sum import (BM, MODES,
                                                   block_segment_sum,
                                                   block_segment_sum_plain)

N, E, D = 9671, 2_000_000, 64
SEED = 0
# |kernel − plain| ≤ TOL_REL_ABSSUM · Σ|m| per element: the same f32
# terms summed in another order
TOL_REL_ABSSUM = 1e-4


def make_inputs(device, n: int = N, e: int = E, d: int = D,
                seed: int = SEED):
    """(msgs, dst, rowptr): dst-sorted f32 messages ``x[src]·w`` of
    ``e`` random edges over ``n`` nodes, padded to the segment layout,
    with their int32 dst and CSR row pointer, on ``device``."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    s, d_, w_ = pad_edges(src, dst, w, n)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    msgs = t(x).index_select(0, t(s)) * t(w_)[:, None]
    return msgs, t(d_), t(build_rowptr(d_, n))


def work(msgs: torch.Tensor, rowptr: torch.Tensor,
         bm: int = BM) -> tuple[int, int]:
    """(bytes, flops) one sum must move and do: the message stream and
    dst read once, one block pointer per block, the output written
    once; one add per message element."""
    e, d = msgs.shape
    n = rowptr.shape[0] - 1
    return e * d * 4 + e * 4 + (-(-n // bm) + 1) * 8 + n * d * 4, e * d


def run(device: str = "cuda", n: int = N, e: int = E, d: int = D,
        seed: int = SEED, reps: int = 25, modes=MODES) -> dict:
    """Check and time every mode; raises if the kernel and the plain
    version disagree past TOL_REL_ABSSUM."""
    dev = resolve(device)
    msgs, dst, rowptr = make_inputs(dev, n, e, d, seed)
    n_bytes, flops = work(msgs, rowptr)
    abssum = block_segment_sum_plain(msgs.abs(), dst, rowptr)
    res = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "n": n, "e_pad": msgs.shape[0], "d": d, "bytes": n_bytes,
           "flops": flops, "bound_ms": bound_ms(n_bytes, flops),
           "bound_by": bound_by(n_bytes, flops), "modes": {}}
    for mode in modes:
        got = block_segment_sum(msgs, dst, rowptr, mode)
        want = block_segment_sum_plain(msgs, dst, rowptr, mode)
        err = (got - want).abs()
        if not (bool((err <= TOL_REL_ABSSUM * abssum).all())
                and got.shape == want.shape):
            raise AssertionError(
                f"block_segment_sum {mode} disagrees with its plain version: "
                f"max |err| {float(err.max()):.3e}")
        res["modes"][mode] = {
            "ms": time_ms(lambda: block_segment_sum(msgs, dst, rowptr, mode),
                          dev, reps),
            "plain_ms": time_ms(lambda: block_segment_sum_plain(
                msgs, dst, rowptr, mode), dev, reps),
            "max_abs_err": float(err.max())}
    out = torch.zeros((n, d), device=dev)
    res["library_ms"] = time_ms(lambda: out.index_add_(0, dst, msgs), dev,
                                reps)
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="recbole_gnn_tpu_torch.diag.pallas_floor",
                                description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--nodes", type=int, default=N)
    p.add_argument("--edges", type=int, default=E)
    p.add_argument("--dim", type=int, default=D)
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--reps", type=int, default=25)
    a = p.parse_args(argv)
    res = run(a.device, a.nodes, a.edges, a.dim, a.seed, a.reps)
    print(f"D1 block_segment_sum on {res['device']}: n={res['n']} "
          f"e_pad={res['e_pad']} d={res['d']}; bound {res['bound_ms']:.4f} "
          f"ms ({res['bytes']} bytes, by {res['bound_by']}); index_add_ "
          f"{res['library_ms']:.4f} ms")
    who = "kernel" if res["device"] != "cpu" else "wrapper (plain, host)"
    for mode, r in res["modes"].items():
        print(f"  {mode:6s}: {who} {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, max_abs_err {r['max_abs_err']:.3e}")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
