"""D2 probe: the row gather at the TPU gather probe's shape.

H100 counterpart of ``scripts/diag/r3_sparse_probe4.py`` case Q (the
Pallas row-DMA gather).  The same inputs, made from numpy
``default_rng(2)``: a 500,000 × 128 f32 table and 2M int32 indices.

    python -m recbole_gnn_tpu_torch.diag.row_gather [--device cpu]

Prints the kernel's time, the plain version's (``index_select``, which
is also the one-call yardstick) and the bound, after checking that the
kernel equals the plain version bit for bit.  On the CPU only the plain
version runs, on the host clock.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from recbole_gnn_tpu_torch.diag.timing import (bound_by, bound_ms, resolve,
                                               time_ms)
from recbole_gnn_tpu_torch.ops.gather import row_gather, row_gather_plain

N, E, D = 500_000, 2_000_000, 128
SEED = 2


def make_inputs(device, n: int = N, e: int = E, d: int = D,
                seed: int = SEED):
    """(x, idx): an (n, d) f32 table and e int32 indices, drawn as the
    TPU probe draws them, on ``device``."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, e).astype(np.int32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(idx).to(device)


def work(x: torch.Tensor, idx: torch.Tensor) -> tuple[int, int]:
    """(bytes, flops) one gather must move and do: each distinct table
    row this index names read once, the index read once, the output
    written once; no arithmetic."""
    d = x.shape[1]
    distinct = int(torch.unique(idx).numel())
    return distinct * d * 4 + idx.shape[0] * 4 + idx.shape[0] * d * 4, 0


def run(device: str = "cuda", n: int = N, e: int = E, d: int = D,
        seed: int = SEED, reps: int = 25) -> dict:
    """Check and time; raises if the kernel differs from the plain
    version in any bit."""
    dev = resolve(device)
    x, idx = make_inputs(dev, n, e, d, seed)
    n_bytes, flops = work(x, idx)
    got, want = row_gather(x, idx), row_gather_plain(x, idx)
    if not torch.equal(got, want):
        raise AssertionError("row_gather differs from index_select")
    plain_ms = time_ms(lambda: row_gather_plain(x, idx), dev, reps)
    return {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "n": n, "e": e, "d": d, "bytes": n_bytes, "flops": flops,
            "bound_ms": bound_ms(n_bytes, flops),
            "bound_by": bound_by(n_bytes, flops),
            "ms": time_ms(lambda: row_gather(x, idx), dev, reps),
            "plain_ms": plain_ms, "library_ms": plain_ms,
            "max_abs_err": float((got - want).abs().max()) if e else 0.0}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="recbole_gnn_tpu_torch.diag.row_gather",
                                description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--nodes", type=int, default=N)
    p.add_argument("--edges", type=int, default=E)
    p.add_argument("--dim", type=int, default=D)
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--reps", type=int, default=25)
    a = p.parse_args(argv)
    res = run(a.device, a.nodes, a.edges, a.dim, a.seed, a.reps)
    who = "kernel" if res["device"] != "cpu" else "wrapper (plain, host)"
    print(f"D2 row_gather on {res['device']}: {res['e']} rows of a "
          f"{res['n']} x {res['d']} table: {who} {res['ms']:.4f} ms, plain "
          f"(index_select) {res['plain_ms']:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms ({res['bytes']} bytes, by "
          f"{res['bound_by']})")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
