"""Row gather ``out[j] = x[idx[j]]`` — the port's D2 kernel.

Counterpart of the Pallas row-DMA gather probe
(``scripts/diag/r3_sparse_probe4.py::case_q.kernel``) and of the gather
half of ``sparse_spmm_impl: xla`` (``msgs = x[src]`` in the JAX
package's ``spmm_coo``).  ``row_gather`` launches the hand-written CUDA
kernel (``csrc/row_gather.cu``) for CUDA tensors and runs the plain
version, :func:`row_gather_plain`, for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from recbole_gnn_tpu_torch.ops import cuda_build


def row_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version: ``x.index_select(0, idx)``."""
    return x.index_select(0, idx)


def row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(len(idx), D) rows ``x[idx[j]]``.

    A CUDA ``x`` launches the kernel (f32 ``x`` of any width, int32
    ``idx`` with entries in ``[0, len(x))``, both contiguous on one
    card; any other input raises).  A CPU ``x`` runs
    :func:`row_gather_plain`.  ``row_gather.launches`` counts kernel
    launches."""
    if x.device.type == "cpu":
        return row_gather_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"row_gather: unsupported device {x.device}")
    cuda_build.check_tensors("row_gather", x.device, (
        ("x", x, torch.float32, 2), ("idx", idx, torch.int32, 1)))
    n_out, d = idx.shape[0], x.shape[1]
    out = torch.empty((n_out, d), dtype=torch.float32, device=x.device)
    if n_out == 0 or d == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.row_gather_f32(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                n_out, d, cuda_build.vec_width(x),
                                stream)
    if rc != 0:
        raise RuntimeError(f"row_gather launch failed: CUDA error {rc}")
    row_gather.launches += 1
    return out


row_gather.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("row_gather")
    fn = lib.row_gather_f32
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return lib
