"""The yardstick's arithmetic: published peaks, the least time of a
launch, and the bytes and operations of one SpMM.

Frozen copies of ``recbole_gnn_tpu_torch/diag/timing.py``'s peaks and
``bound_ms`` / ``bound_by``, and of ``chip_smoke.py``'s ``spmm_bytes``
(x read once, out written once, 8 bytes per real edge, 2·E·d
operations), so that a later change to the program cannot move the
bound it is measured against.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
power limit): HBM3 at 3.35 TB/s, float32 outside the tensor cores at
67 TFLOP/s.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def bound_ms(n_bytes: float, flops: float) -> float:
    """Least time on the card: the larger of bytes over HBM bandwidth
    and fp32 operations over the fp32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3


def bound_by(n_bytes: float, flops: float) -> str:
    return ("bytes" if n_bytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
            else "operations")


def spmm_bytes(n_out: int, n_in: int, e: int, d: int, x_bytes: int = 4,
               out_bytes: int = 4) -> tuple[int, int]:
    """(bytes, flops) of one SpMM over ``e`` real edges: x read once,
    out written once, 8 bytes per real edge (its int32 index and f32
    weight), 2·E·d operations.  Whatever layout or kernel does the work
    is held to this count."""
    return n_in * d * x_bytes + n_out * d * out_bytes + 8 * e, 2 * e * d
