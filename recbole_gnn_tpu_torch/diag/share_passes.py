"""K1's precision modes and D1's weighted share pass at the LightGCN slice
shape, against variants and earlier sources of the kernels, on the card.

    python -m recbole_gnn_tpu_torch.diag.share_passes [--variants]
        [--baseline-k1 PATH] [--baseline-d1 PATH] [--out FILE]

Builds the graph ``chip_smoke.py`` trains on (the Gowalla-shape log of
:mod:`~recbole_gnn_tpu_torch.diag.gowalla_shape`; LightGCN, 64 wide) and
runs, on its CSR and reverse CSR:

* K1 (``csrc/segment_spmm.cu``) in ``f32x2``, ``bf16`` and ``packed`` on
  the f32 embedding table and on its bf16 copy, and K1ᵀ in each on an
  f32 cotangent (the pack pass, where the mode has one, inside the
  call);
* D1 (``csrc/segment_sum.cu``) with the edge weight on the gathered f32
  rows and on their bf16 copy, as the ``xla`` path calls it.

Each kernel source runs through the same inputs in turns (the tree's,
then the variants and baselines, then them reversed, then the tree's):
its outputs are held bit for bit against the tree's kernel's (K1, every
mode: a variant or an earlier source of the same arithmetic must give
the same bits) or within the chip checks' bound (D1: an earlier
source sums in another order), and each call is timed by
``timing.time_ms`` (CUDA events, L2 flushed, median of 25).
``--variants`` adds each entry of :data:`D1_VARIANTS` (the tree's D1
source with one element changed by exact text replacement);
``--baseline-k1`` / ``--baseline-d1`` add an earlier source of the
kernel, launched through its own C interface (the one before the
packed table, or before D1's bf16 messages took the share pass).  For
each source that has one it prints what the share pass's instances use
(registers, local memory, resident blocks per SM), and the
``-Xptxas=-v`` lines of every build.  Prints one JSON object per
source and turn; ``--out`` writes them all to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile
import time

import torch

from recbole_gnn_tpu_torch.diag import ell_l2
from recbole_gnn_tpu_torch.diag.timing import resolve, time_ms
from recbole_gnn_tpu_torch.ops import cuda_build
from recbole_gnn_tpu_torch.ops import segment_spmm as k1
from recbole_gnn_tpu_torch.ops import segment_sum as d1

# each D1 variant: the tree's D1 source with one element changed, as
# (text, replacement) pairs that must each match exactly once; bf16
# messages only (the f32 instances are left as they are)
D1_VARIANTS: dict[str, list[tuple[str, str]]] = {
    # slabs of 8 KB (64 rows at D = 64), two blocks on an SM
    "slab8k_min2": [("constexpr int kSlabBytesBf16 = 4096;",
                     "constexpr int kSlabBytesBf16 = 8192;"),
                    ("constexpr int kMinBlocksBf16 = 4;",
                     "constexpr int kMinBlocksBf16 = 2;")],
    # slabs of 3 KB (24 rows), five blocks on an SM (102 registers)
    "slab3k_min5": [("constexpr int kSlabBytesBf16 = 4096;",
                     "constexpr int kSlabBytesBf16 = 3072;"),
                    ("constexpr int kMinBlocksBf16 = 4;",
                     "constexpr int kMinBlocksBf16 = 5;")],
}

# the bound on D1 against the tree's D1 (another sum order; bf16: one
# rounding apart at most): |Δ| ≤ BF16_REL·|tree| + ABSSUM_REL·Σ|term|
ABSSUM_REL, BF16_REL = 1e-4, 2.0 ** -7


def variant_source(name: str) -> str:
    """``csrc/segment_sum.cu`` with the replacements of variant ``name``
    of :data:`D1_VARIANTS`."""
    with open(os.path.join(cuda_build.CSRC_DIR, "segment_sum.cu")) as f:
        text = f.read()
    for old, new in D1_VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} matches "
                             f"{text.count(old)} times in segment_sum.cu")
        text = text.replace(old, new)
    return text


def build_sources(sources: dict[str, str], build_dir: str) -> dict:
    """Compile each ``{name: source text}`` at once (one ``nvcc`` each,
    ``csrc/`` on the include path); returns ``{name: ctypes.CDLL or the
    compiler's output where the build failed}``."""
    procs = {}
    for name, text in sources.items():
        src, lib = ell_l2._build_source(name, text, build_dir)
        procs[name] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             cuda_build.CSRC_DIR, "-o", lib, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        for line in cuda_build.ptxas_usage(log):
            print(f"  ptxas {name}: {json.dumps(line)}", flush=True)
        if proc.returncode != 0:
            print(f"build of {name} failed:\n{log[-4000:]}", flush=True)
            libs[name] = log
        else:
            libs[name] = ctypes.CDLL(lib)
    return libs


def k1_launch(lib: ctypes.CDLL, g: dict, x: torch.Tensor,
              precision: str) -> torch.Tensor:
    """K1 of ``lib`` on x over the CSR ``g`` (src, dst, weight, rowptr),
    through the tree's C interface or, where the library has no
    ``segment_spmm_share_usage``, the one before the packed table."""
    new = hasattr(lib, "segment_spmm_share_usage")
    fn = lib.segment_spmm_launch
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = ([vp] * 8 + [ll] * 3 if new else [vp] * 7 + [ll] * 2) + \
        [i] * 5 + [vp]
    fn.restype = i
    n_rows, (e, d) = g["rowptr"].shape[0] - 1, (g["src"].shape[0],
                                                 x.shape[1])
    out = torch.empty((n_rows, d), dtype=torch.float32, device=x.device)
    carry = torch.empty(k1.share_workspace_shape(e, d), dtype=torch.float32,
                        device=x.device)
    shape = k1.pack_workspace_shape(x, precision)
    xpack = None if shape is None else torch.empty(
        shape, dtype=torch.float32, device=x.device)
    ptrs = [x.data_ptr(), g["src"].data_ptr(), g["weight"].data_ptr(),
            g["dst"].data_ptr(), g["rowptr"].data_ptr(), out.data_ptr(),
            carry.data_ptr()]
    sizes = [n_rows, e]
    if new:
        ptrs.append(None if xpack is None else xpack.data_ptr())
        sizes = [n_rows, x.shape[0], e]
    rc = fn(*ptrs, *sizes, d, cuda_build.vec_width(x), k1.SHARE_EDGES,
            k1.PRECISIONS.index(precision), int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_spmm_launch: CUDA error {rc}")
    return out


def d1_launch(lib: ctypes.CDLL, msgs: torch.Tensor, dst: torch.Tensor,
              rowptr: torch.Tensor, weight: torch.Tensor,
              vec: int) -> torch.Tensor:
    """D1 of ``lib`` in f32 mode with the weight (its C interface is the
    same in both designs), with ``vec``-element pieces."""
    lib.block_segment_sum_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.block_segment_sum_launch.restype = ctypes.c_int
    rows_fn = lib.block_segment_sum_carry_rows
    rows_fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 4
    rows_fn.restype = ctypes.c_longlong
    n_rows, (e, d) = rowptr.shape[0] - 1, msgs.shape
    bf16 = int(msgs.dtype == torch.bfloat16)
    out = torch.empty((n_rows, d), dtype=msgs.dtype, device=msgs.device)
    carry = torch.empty((rows_fn(e, d, 1, d1.SHARE_EDGES, bf16), 2, d),
                        dtype=torch.float32, device=msgs.device)
    rc = lib.block_segment_sum_launch(
        msgs.data_ptr(), dst.data_ptr(), rowptr.data_ptr(),
        weight.data_ptr(), out.data_ptr(), carry.data_ptr(), n_rows, e, d,
        vec, 0, d1.BM, d1.EC, d1.SHARE_EDGES, 0, bf16,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block_segment_sum_launch: CUDA error {rc}")
    return out


def d1_vec(lib: ctypes.CDLL, msgs: torch.Tensor, out_like: torch.Tensor
           ) -> int:
    """The pieces each design's wrapper gives D1: the share pass's lane
    width; bf16 messages in the design before, the widest piece that
    both the messages and out allow."""
    if (msgs.dtype == torch.bfloat16
            and not hasattr(lib, "block_segment_sum_share_usage")):
        return min(cuda_build.vec_width(msgs), cuda_build.vec_width(out_like))
    return d1._lane_width(msgs.shape[1], out_like)


def usage(lib: ctypes.CDLL, d: int) -> dict:
    """The share passes' instances at the slice's widths, where the
    library reports them."""
    out = {}
    if hasattr(lib, "segment_spmm_share_usage"):
        for p in k1.PRECISIONS:
            for dt, vec in ((torch.float32, 4), (torch.bfloat16, 8)):
                out[f"K1 {p} {str(dt)[6:]} x"] = k1.share_pass_usage(
                    p, dt, vec, d, lib=lib)
    if hasattr(lib, "block_segment_sum_share_usage"):
        for dt in (torch.float32, torch.bfloat16):
            out[f"D1 weighted {str(dt)[6:]}"] = d1.share_pass_usage(
                "f32", True, dt, 2, d, lib=lib)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--baseline-k1")
    ap.add_argument("--baseline-d1")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    dev = resolve("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory(prefix="share_passes_") as tmp:
        k1_src = {"tree": open(os.path.join(cuda_build.CSRC_DIR,
                                            "segment_spmm.cu")).read()}
        d1_src = {"tree": open(os.path.join(cuda_build.CSRC_DIR,
                                            "segment_sum.cu")).read()}
        if args.variants:
            d1_src.update({n: variant_source(n) for n in D1_VARIANTS})
        for srcs, path in ((k1_src, args.baseline_k1),
                           (d1_src, args.baseline_d1)):
            if path:
                srcs["baseline"] = open(path).read()
        built = build_sources({f"k1_{n}": t for n, t in k1_src.items()}
                              | {f"d1_{n}": t for n, t in d1_src.items()},
                              os.path.join(tmp, "build"))
        failed = {n: "build failed" for n, lib in built.items()
                  if isinstance(lib, str)}
        if "k1_tree" in failed or "d1_tree" in failed:
            raise RuntimeError(f"the tree's kernels did not build: {failed}")
        k1_libs = {n[3:]: lib for n, lib in built.items()
                   if n.startswith("k1_") and n not in failed}
        d1_libs = {n[3:]: lib for n, lib in built.items()
                   if n.startswith("d1_") and n not in failed}
        for name, lib in built.items():
            if name not in failed:
                print(json.dumps({"source": name,
                                  "usage": usage(lib, 64)}), flush=True)
        t0 = time.perf_counter()
        s = ell_l2.slice_setup(tmp, dev, n_batches=1)
        g = s["graph"]
        fwd = {"src": g.src, "dst": g.dst, "weight": g.weight,
               "rowptr": g.rowptr}
        rev = {"src": g.rev_src, "dst": g.rev_dst, "weight": g.rev_weight,
               "rowptr": g.rev_rowptr}
        x, cot = s["x"], s["cot"]
        xb = x.to(torch.bfloat16)
        raw = x.index_select(0, g.src.long())
        rawb = raw.to(torch.bfloat16)
        print(json.dumps({"setup_s": time.perf_counter() - t0,
                          "rows": g.n_nodes, "edges": int(g.src.numel())}),
              flush=True)
        cases = [(f"K1 {p} {dt} x", fwd, inp, p)
                 for p in k1.PRECISIONS for dt, inp in (("f32", x),
                                                        ("bf16", xb))]
        cases += [(f"K1T {p}", rev, cot, p) for p in k1.PRECISIONS]
        d1_cases = [("D1 weighted f32", raw), ("D1 weighted bf16", rawb)]
        results = []
        with torch.inference_mode():
            ref = {c[0]: k1_launch(k1_libs["tree"], c[1], c[2], c[3])
                   for c in cases}
            ref |= {name: d1_launch(d1_libs["tree"], m, g.dst, g.rowptr,
                                    g.weight, d1_vec(d1_libs["tree"], m, m))
                    for name, m in d1_cases}
            abssum = {name: d1.block_segment_sum_plain(
                m.float().abs(), g.dst, g.rowptr, weight=g.weight.abs())
                for name, m in d1_cases}
            order = list(k1_libs) + list(k1_libs)[::-1]
            for turn, name in enumerate(order):
                lib = k1_libs[name]
                for case, arrays, inp, p in cases:
                    got = k1_launch(lib, arrays, inp, p)
                    r = {"source": f"k1 {name}", "turn": turn, "case": case,
                         "bit_equal_to_tree": bool(torch.equal(got,
                                                               ref[case])),
                         "ms": time_ms(lambda: k1_launch(lib, arrays, inp,
                                                         p), dev)}
                    print(json.dumps(r), flush=True)
                    results.append(r)
            order = list(d1_libs) + list(d1_libs)[::-1]
            for turn, name in enumerate(order):
                lib = d1_libs[name]
                for case, m in d1_cases:
                    vec = d1_vec(lib, m, m)
                    got = d1_launch(lib, m, g.dst, g.rowptr, g.weight, vec)
                    err = (got.float() - ref[case].float()).abs()
                    bound = (BF16_REL * ref[case].float().abs()
                             if m.dtype == torch.bfloat16 else 0) \
                        + ABSSUM_REL * abssum[case]
                    r = {"source": f"d1 {name}", "turn": turn, "case": case,
                         "vec": vec, "bit_equal_to_tree": bool(
                             torch.equal(got, ref[case])),
                         "max_abs_err_vs_tree": float(err.max()),
                         "within_bound": bool((err <= bound).all()),
                         "ms": time_ms(lambda: d1_launch(
                             lib, m, g.dst, g.rowptr, g.weight, vec), dev)}
                    print(json.dumps(r), flush=True)
                    results.append(r)
    bad = [r for r in results if (r["source"].startswith("k1")
                                  and not r["bit_equal_to_tree"])
           or (r["source"].startswith("d1") and not r["within_bound"])]
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "failed_builds": failed,
                       "results": results}, f, indent=1)
    if bad:
        print(f"share_passes: {len(bad)} results differ: "
              f"{json.dumps(bad[:4])}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
