"""Block segment sum of dst-sorted message rows — the port's D1 kernel.

Counterpart of the Pallas floor probe
(``scripts/diag/pallas_floor.py::make_kernel``: K1's body without its
gather, one program per BM = 64-row block summing the message chunks of
its edge range) and of the reduction half of ``sparse_spmm_impl: xla``
(``x[src] * w`` and the sorted ``segment_sum`` of the JAX package's
``spmm_coo``).

``block_segment_sum`` launches the hand-written CUDA kernel
(``csrc/segment_sum.cu``) for CUDA tensors and runs the plain version,
:func:`block_segment_sum_plain`, for CPU tensors only.  Its modes are
the probe's:

  * ``f32``: the exact sum; with ``weight``, the sum of
    ``weight[e]·msgs[e]``, each product rounded once (the ``xla`` path,
    whose edge-weight product is taken inside the sum);
  * ``bf16``: Σ of bf16-rounded messages in f32 (the probe's
    ``n_pass=1``);
  * ``hilo``: Σ (hi + lo), hi = bf16(m), lo = bf16(m − hi)
    (``n_pass=2``);
  * ``stream``: the probe's copy floor (``n_pass=0``).  Block i, with
    edge range ``[start, end)``, reads every ``ec``-edge chunk that
    range touches and adds only ``msgs[c·ec + r]`` to row ``i·bm + r``,
    where ``r = dst[c·ec] − i·bm`` lies in ``[0, bm)``.  Block i's edge
    range is ``rowptr[i·bm]`` to ``rowptr[min((i+1)·bm, n)]`` — the
    probe's ``block_ptr`` read off the CSR row pointer.

bf16 messages (``activation_dtype: bfloat16``, the ``xla`` path) are
summed in ``f32`` mode with the edge weight only: each term is
``bf16(bf16(weight[e])·msgs[e])``, as the JAX package's ``x[src] *
w.astype(bf16)`` forms it, the sum is taken in f32 and the bf16 output
rounded once per element (``out=``: ``bf16(out + Σ)``).  The kernel
stages the bf16 rows through the same share pass as f32 messages.  The
other modes take f32 messages.

``bm`` and ``ec`` define the stream mode only.  The kernel runs the
other three modes on equal edge shares of ``SHARE_EDGES`` edges, one
warp each, whatever rows they fall in, and sums a row that crosses a
share boundary from its partial sums in share order — the schedule of
K1 (``ops/segment_spmm.py``); the partials of a block of shares are
added in shared memory, the block's carries by a second kernel.
:func:`block_segment_sum_shares_plain` computes the sum by the share
schedule in plain torch (the same partial sums, added in the same
order), for the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes

import torch

from recbole_gnn_tpu_torch.ops import cuda_build
from recbole_gnn_tpu_torch.ops.segment_spmm import share_sum_plain

MODES = ("f32", "bf16", "hilo", "stream")
BM = 64      # rows per block of the stream mode (the probe's BM)
EC = 2048    # edges per chunk of the stream mode (the probe's EC)

# edges per share (one warp's) of the kernel's schedule (f32, bf16,
# hilo): the size that chip_smoke.py checks (PERF.md)
SHARE_EDGES = 128


def _terms(msgs: torch.Tensor, mode: str,
           weight: torch.Tensor | None = None) -> torch.Tensor:
    """The term each message adds in ``mode`` (f32, bf16, hilo), in f32
    (bf16 messages: ``bf16(bf16(w)·m)``)."""
    if msgs.dtype == torch.bfloat16:
        wb = weight.to(torch.bfloat16).to(torch.float32)
        return (wb[:, None] * msgs.to(torch.float32)).to(
            torch.bfloat16).to(torch.float32)
    if mode == "f32":
        return msgs if weight is None else weight[:, None] * msgs
    hi = msgs.to(torch.bfloat16).to(msgs.dtype)
    if mode == "bf16":
        return hi
    return hi + (msgs - hi).to(torch.bfloat16).to(msgs.dtype)


def _stream_plain(msgs, dst, rowptr, out, bm, ec):
    n = rowptr.shape[0] - 1
    dev = msgs.device
    n_blocks = -(-n // bm)
    bounds = torch.clamp(torch.arange(n_blocks + 1, device=dev) * bm, max=n)
    start, end = rowptr[bounds[:-1]], rowptr[bounds[1:]]
    c0 = start // ec
    count = torch.where(end > start, (end - 1) // ec - c0 + 1, 0)
    blk = torch.repeat_interleave(torch.arange(n_blocks, device=dev), count)
    first = torch.repeat_interleave(torch.cumsum(count, 0) - count, count)
    chunk = c0[blk] + torch.arange(blk.shape[0], device=dev) - first
    r = dst[chunk * ec].long() - blk * bm
    keep = (r >= 0) & (r < bm)
    return out.index_add_(0, (blk * bm + r)[keep],
                          msgs.index_select(0, (chunk * ec + r)[keep]))


def block_segment_sum_plain(msgs: torch.Tensor, dst: torch.Tensor,
                            rowptr: torch.Tensor, mode: str = "f32",
                            out: torch.Tensor | None = None,
                            weight: torch.Tensor | None = None, bm: int = BM,
                            ec: int = EC) -> torch.Tensor:
    """The plain version of every mode, following the definitions in
    the module docstring; sums the edges ``[rowptr[0], rowptr[-1])``
    with ``index_add_`` (into ``out`` in place when given, else into
    zeros).  bf16 messages: the terms summed in f32, the output (and
    ``out``, which is then overwritten) bf16, rounded once."""
    _check_mode(msgs, mode, weight, bm, ec)
    if msgs.dtype == torch.bfloat16:
        terms = _terms(msgs, mode, weight)
        return _bf16_out(lambda o: block_segment_sum_plain(
            terms, dst, rowptr, "f32", o), out)
    if out is None:
        out = torch.zeros((rowptr.shape[0] - 1, msgs.shape[1]),
                          dtype=msgs.dtype, device=msgs.device)
    if mode == "stream":
        return _stream_plain(msgs, dst, rowptr, out, bm, ec)
    lo, hi = rowptr[[0, -1]].clamp(max=msgs.shape[0]).tolist()
    w = None if weight is None else weight[lo:hi]
    return out.index_add_(0, dst[lo:hi], _terms(msgs[lo:hi], mode, w))


def block_segment_sum_shares_plain(msgs: torch.Tensor, rowptr: torch.Tensor,
                                   mode: str = "f32",
                                   out: torch.Tensor | None = None,
                                   weight: torch.Tensor | None = None,
                                   share_edges: int = SHARE_EDGES
                                   ) -> torch.Tensor:
    """The kernel's sum in ``mode`` (f32, bf16, hilo) computed by its
    share schedule in plain torch (``ops.segment_spmm.share_sum_plain``
    over the mode's terms), added to ``out`` when given, as the kernel
    adds each row's sum to it.  For the tests and ``chip_smoke.py``;
    the wrapper's plain version is :func:`block_segment_sum_plain`."""
    _check_mode(msgs, mode, weight, BM, EC)
    if mode == "stream":
        raise ValueError("block_segment_sum: stream mode has no share "
                         "schedule")
    if msgs.dtype == torch.bfloat16:
        terms = _terms(msgs, mode, weight)
        return _bf16_out(lambda o: block_segment_sum_shares_plain(
            terms, rowptr, "f32", o, share_edges=share_edges), out)
    got = share_sum_plain(_terms(msgs, mode, weight), rowptr, share_edges)
    return got if out is None else out.add_(got)


def _bf16_out(f32_sum, out):
    """A plain version on bf16 messages: ``f32_sum`` (given an f32
    ``out`` or None) sums their f32 terms, into ``out`` widened when it
    is given; the result rounded to bf16 once (written into ``out``
    when it is given)."""
    acc = f32_sum(None if out is None else out.to(torch.float32))
    if out is None:
        return acc.to(torch.bfloat16)
    return out.copy_(acc)


def _check_mode(msgs, mode, weight, bm, ec):
    if mode not in MODES:
        raise ValueError(f"block_segment_sum: mode must be one of {MODES}, "
                         f"got {mode!r}")
    if msgs.dtype == torch.bfloat16 and (mode != "f32" or weight is None):
        raise ValueError("block_segment_sum: bf16 messages are summed in "
                         "f32 mode with a weight only")
    if weight is not None and mode != "f32":
        raise ValueError(f"block_segment_sum: a weight is summed in f32 "
                         f"mode only, got mode {mode!r}")
    if bm < 1:
        raise ValueError(f"block_segment_sum: bm must be >= 1, got {bm}")
    if mode == "stream" and (ec < 4 or ec % 4 or msgs.shape[0] % ec):
        raise ValueError(
            f"block_segment_sum: stream mode needs ec % 4 == 0 and the "
            f"edge count ({msgs.shape[0]}) a multiple of ec ({ec})")


def _check_cuda_args(msgs, dst, rowptr, out, weight, mode):
    cuda_build.check_row_dtype("block_segment_sum", "msgs", msgs)
    specs = [("msgs", msgs, msgs.dtype, 2), ("dst", dst, torch.int32, 1),
             ("rowptr", rowptr, torch.int64, 1)]
    if out is not None:
        specs.append(("out", out, msgs.dtype, 2))
    if weight is not None:
        specs.append(("weight", weight, torch.float32, 1))
    cuda_build.check_tensors("block_segment_sum", msgs.device, specs)
    e = msgs.shape[0]
    if dst.shape[0] != e or (weight is not None and weight.shape[0] != e):
        raise ValueError(
            f"block_segment_sum: msgs has {e} edges, dst {dst.shape[0]}"
            + ("" if weight is None else f", weight {weight.shape[0]}"))
    if rowptr.shape[0] < 1:
        raise ValueError("block_segment_sum: rowptr needs n_rows + 1 >= 1 "
                         "entries")
    n_rows = rowptr.shape[0] - 1
    if out is not None and tuple(out.shape) != (n_rows, msgs.shape[1]):
        raise ValueError(f"block_segment_sum: out must be "
                         f"{(n_rows, msgs.shape[1])}, got {tuple(out.shape)}")
    if mode == "stream" and msgs.data_ptr() % 16:
        raise ValueError("block_segment_sum: stream mode needs msgs "
                         "16-byte aligned")


def _lane_width(d: int, out: torch.Tensor) -> int:
    """Elements (of the messages' type) per lane of the share pass's
    shared-memory reads and output stores: the widest that divides the
    row and the output's alignment, narrowed while half a warp would
    cover the row."""
    vec = cuda_build.vec_width(out)
    while vec > 1 and d <= 16 * vec:
        vec //= 2
    return vec


def block_segment_sum(msgs: torch.Tensor, dst: torch.Tensor,
                      rowptr: torch.Tensor, mode: str = "f32",
                      out: torch.Tensor | None = None,
                      weight: torch.Tensor | None = None, bm: int = BM,
                      ec: int = EC) -> torch.Tensor:
    """Sum dst-sorted message rows into ``len(rowptr) - 1`` rows.

    ``msgs`` (E, D) are sorted by ``dst`` (E,), and ``rowptr`` is their
    CSR row pointer; edges outside ``[rowptr[0], rowptr[-1])`` belong
    to no row.  ``weight`` (E,), f32 mode only, scales each message
    first.  A given ``out`` is accumulated into in place (the TPU
    kernel's ``prev_ref`` alias) and returned, its rows without edges
    left as they are; otherwise a new tensor is.  A CUDA ``msgs``
    launches the kernel (f32 ``msgs``/``out``/``weight``, or bf16
    ``msgs``/``out`` in f32 mode with the f32 weight, int32 ``dst``,
    int64 ``rowptr``, all contiguous on one card; any other input
    raises); f32, bf16 and hilo, and bf16 messages, run one share pass
    and a carry pass over a workspace of one (2, D) slot pair per block
    of shares, sized by the kernel's library.  The output has
    the messages' dtype.  A CPU
    ``msgs`` runs :func:`block_segment_sum_plain`.
    ``block_segment_sum.launches`` counts kernel launches."""
    if msgs.device.type == "cpu":
        return block_segment_sum_plain(msgs, dst, rowptr, mode, out, weight,
                                       bm, ec)
    if msgs.device.type != "cuda":
        raise ValueError(f"block_segment_sum: unsupported device "
                         f"{msgs.device}")
    out = _block_segment_sum_cuda(msgs, dst, rowptr, mode, out, weight, bm,
                                  ec, SHARE_EDGES)
    if out.numel():                 # an empty output launches nothing
        block_segment_sum.launches += 1
    return out


block_segment_sum.launches = 0


def _block_segment_sum_cuda(msgs, dst, rowptr, mode, out, weight, bm, ec,
                            share_edges: int) -> torch.Tensor:
    """The kernel over shares of ``share_edges`` edges, on CUDA tensors;
    counts nothing and launches nothing for an empty output.
    ``chip_smoke.py`` calls it to check other share sizes."""
    _check_mode(msgs, mode, weight, bm, ec)
    _check_cuda_args(msgs, dst, rowptr, out, weight, mode)
    n_rows, (e, d) = rowptr.shape[0] - 1, msgs.shape
    accumulate = out is not None
    bf16 = msgs.dtype == torch.bfloat16
    if out is None:
        out = torch.empty((n_rows, d), dtype=msgs.dtype, device=msgs.device)
    if n_rows == 0 or d == 0:
        return out
    lib = _library()
    carry = None
    if mode != "stream":
        # one carry slot pair per block of the share pass, as the .cu
        # lays its grid out for the messages' element size
        rows = lib.block_segment_sum_carry_rows(e, d, int(weight is not None),
                                                share_edges, int(bf16))
        if rows < 0:
            raise ValueError(f"block_segment_sum: no share layout for rows "
                             f"of {d} floats at share_edges={share_edges}")
        carry = torch.empty((rows, 2, d), dtype=torch.float32,
                            device=msgs.device)
    with torch.cuda.device(msgs.device):
        stream = torch.cuda.current_stream(msgs.device).cuda_stream
        rc = lib.block_segment_sum_launch(
            msgs.data_ptr(), dst.data_ptr(), rowptr.data_ptr(),
            None if weight is None else weight.data_ptr(), out.data_ptr(),
            None if carry is None else carry.data_ptr(), n_rows, e, d,
            _lane_width(d, out), MODES.index(mode), bm, ec, share_edges,
            int(accumulate), int(bf16), stream)
    if rc != 0:
        raise RuntimeError(f"block_segment_sum launch failed: CUDA error {rc}")
    return out


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("segment_sum")
    fn = lib.block_segment_sum_launch
    if fn.argtypes is None:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ll, ll, i, i, i, i, i, i, i,
                       i, vp]
        fn.restype = ctypes.c_int
    rows = lib.block_segment_sum_carry_rows
    if rows.argtypes is None:
        rows.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int]
        rows.restype = ctypes.c_longlong
    return lib
