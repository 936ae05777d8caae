"""Timing and roofline bounds for the probes of the port's kernels
(``diag/pallas_floor.py``, ``diag/row_gather.py``).

A time on the card is the median of CUDA-event intervals, each launch
after a 256 MB write that evicts the 50 MB L2 (the main path finds its
inputs cold at these sizes) and a spin kernel that keeps the card busy
while the host prepares the launch, so that the interval holds the
device's time and not the wrapper's host time.  On the CPU it is the
host clock: a number about PyTorch's CPU kernels, never a device
metric.

Bounds use the H100 SXM's published peaks (NVIDIA data sheet, at the
700 W power limit): HBM3 at 3.35 TB/s, fp32 outside the tensor cores
at 67 TFLOP/s.
"""

from __future__ import annotations

import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# cycles of the spin before each timed launch (~0.5 ms at the H100's
# clock): longer than any wrapper's host time
SPIN_CYCLES = 1_000_000


def resolve(device: str) -> torch.device:
    """The probe's device; ``cuda`` without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes run on the card; "
                           "pass --device cpu to run the plain versions "
                           "on the host")
    return dev


def time_ms(fn, device: torch.device, reps: int = 25,
            warmup: int = 3) -> float:
    """Median time of ``fn()`` in ms: CUDA events with the L2 flushed
    and the card kept busy before each launch on a CUDA device, the
    host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type != "cuda":
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    flush = torch.empty(64 << 20, dtype=torch.float32, device=device)
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(n_bytes: int, flops: int) -> float:
    """Least time on the card: the larger of bytes over HBM bandwidth
    and fp32 operations over the fp32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3


def bound_by(n_bytes: int, flops: int) -> str:
    return ("bytes" if n_bytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
            else "operations")

