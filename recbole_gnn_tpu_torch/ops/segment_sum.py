"""Block segment sum of dst-sorted message rows — the port's D1 kernel.

Counterpart of the Pallas floor probe
(``scripts/diag/pallas_floor.py::make_kernel``: K1's body without its
gather, one program per BM = 64-row block summing the message chunks of
its edge range) and of the reduction half of ``sparse_spmm_impl: xla``
(the sorted ``segment_sum`` of the JAX package's ``spmm_coo``).

``block_segment_sum`` launches the hand-written CUDA kernel
(``csrc/segment_sum.cu``) for CUDA tensors and runs the plain version,
:func:`block_segment_sum_plain`, for CPU tensors only.  Its modes are
the probe's:

  * ``f32``: the exact sum (the ``xla`` path);
  * ``bf16``: Σ of bf16-rounded messages in f32 (the probe's
    ``n_pass=1``);
  * ``hilo``: Σ (hi + lo), hi = bf16(m), lo = bf16(m − hi)
    (``n_pass=2``);
  * ``stream``: the probe's copy floor (``n_pass=0``).  Block i, with
    edge range ``[start, end)``, reads every ``ec``-edge chunk that
    range touches and adds only ``msgs[c·ec + r]`` to row ``i·bm + r``,
    where ``r = dst[c·ec] − i·bm`` lies in ``[0, bm)``.

Block i's edge range is ``rowptr[i·bm]`` to ``rowptr[min((i+1)·bm, n)]``
— the probe's ``block_ptr`` read off the CSR row pointer the ``Graph``
already carries.
"""

from __future__ import annotations

import ctypes

import torch

from recbole_gnn_tpu_torch.ops import cuda_build

MODES = ("f32", "bf16", "hilo", "stream")
BM = 64      # rows per block (the probe's BM)
EC = 2048    # edges per chunk of the stream mode (the probe's EC)


def _rounded(msgs: torch.Tensor, mode: str) -> torch.Tensor:
    """The term each message adds in ``mode`` (f32, bf16, hilo)."""
    if mode == "f32":
        return msgs
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
                            out: torch.Tensor | None = None, bm: int = BM,
                            ec: int = EC) -> torch.Tensor:
    """The plain version of every mode, following the definitions in
    the module docstring; sums with ``index_add_`` (into ``out`` in
    place when given, else into zeros)."""
    _check_mode(msgs, mode, bm, ec)
    if out is None:
        out = torch.zeros((rowptr.shape[0] - 1, msgs.shape[1]),
                          dtype=msgs.dtype, device=msgs.device)
    if mode == "stream":
        return _stream_plain(msgs, dst, rowptr, out, bm, ec)
    return out.index_add_(0, dst, _rounded(msgs, mode))


def _check_mode(msgs, mode, bm, ec):
    if mode not in MODES:
        raise ValueError(f"block_segment_sum: mode must be one of {MODES}, "
                         f"got {mode!r}")
    if bm < 1:
        raise ValueError(f"block_segment_sum: bm must be >= 1, got {bm}")
    if mode == "stream" and (ec < 4 or ec % 4 or msgs.shape[0] % ec):
        raise ValueError(
            f"block_segment_sum: stream mode needs ec % 4 == 0 and the "
            f"edge count ({msgs.shape[0]}) a multiple of ec ({ec})")


def _check_cuda_args(msgs, dst, rowptr, out, mode):
    specs = [("msgs", msgs, torch.float32, 2), ("dst", dst, torch.int32, 1),
             ("rowptr", rowptr, torch.int64, 1)]
    if out is not None:
        specs.append(("out", out, torch.float32, 2))
    cuda_build.check_tensors("block_segment_sum", msgs.device, specs)
    if dst.shape[0] != msgs.shape[0]:
        raise ValueError(f"block_segment_sum: dst has {dst.shape[0]} edges, "
                         f"msgs {msgs.shape[0]}")
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


def _load_width(msgs: torch.Tensor) -> int:
    """Floats per lane of the message loads: the widest the row allows,
    narrowed while half a warp's loads would cover the row."""
    vec, d = cuda_build.vec_width(msgs), msgs.shape[1]
    while vec > 1 and d <= 16 * vec:
        vec //= 2
    return vec


def block_segment_sum(msgs: torch.Tensor, dst: torch.Tensor,
                      rowptr: torch.Tensor, mode: str = "f32",
                      out: torch.Tensor | None = None, bm: int = BM,
                      ec: int = EC) -> torch.Tensor:
    """Sum dst-sorted message rows into ``len(rowptr) - 1`` rows.

    ``msgs`` (E, D) are sorted by ``dst`` (E,), and ``rowptr`` is their
    CSR row pointer (``rowptr[0] == 0``, ``rowptr[-1] == E``).  A given
    ``out`` is accumulated into in place (the TPU kernel's ``prev_ref``
    alias), and returned; otherwise a new tensor is.  A CUDA ``msgs``
    launches the kernel (f32 ``msgs``/``out``, int32 ``dst``, int64
    ``rowptr``, all contiguous on one card; any other input raises).  A
    CPU ``msgs`` runs :func:`block_segment_sum_plain`.
    ``block_segment_sum.launches`` counts kernel launches."""
    if msgs.device.type == "cpu":
        return block_segment_sum_plain(msgs, dst, rowptr, mode, out, bm, ec)
    if msgs.device.type != "cuda":
        raise ValueError(f"block_segment_sum: unsupported device "
                         f"{msgs.device}")
    _check_mode(msgs, mode, bm, ec)
    _check_cuda_args(msgs, dst, rowptr, out, mode)
    n_rows, d = rowptr.shape[0] - 1, msgs.shape[1]
    accumulate = out is not None
    if out is None:
        out = torch.empty((n_rows, d), dtype=torch.float32,
                          device=msgs.device)
    if n_rows == 0 or d == 0:
        return out
    lib = _library()
    with torch.cuda.device(msgs.device):
        stream = torch.cuda.current_stream(msgs.device).cuda_stream
        rc = lib.block_segment_sum_f32(
            msgs.data_ptr(), dst.data_ptr(), rowptr.data_ptr(),
            out.data_ptr(), n_rows, d, _load_width(msgs), MODES.index(mode),
            bm, ec, int(accumulate), stream)
    if rc != 0:
        raise RuntimeError(f"block_segment_sum launch failed: CUDA error {rc}")
    block_segment_sum.launches += 1
    return out


block_segment_sum.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("segment_sum")
    fn = lib.block_segment_sum_f32
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, i, i, i, i, i, i,
                       vp]
        fn.restype = ctypes.c_int
    return lib
