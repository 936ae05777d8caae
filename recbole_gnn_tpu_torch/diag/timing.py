"""Timing and roofline bounds for the port's kernels.

A time on the card is the median of CUDA-event intervals, each launch
after a 256 MB write that evicts the 50 MB L2 (the main path finds its
inputs cold at these sizes) and a spin kernel that keeps the card busy
while the host prepares the launch, so that the interval holds the
device's time and not the wrapper's host time.  That host time is
measured apart, by :func:`host_us_per_call`.  :func:`kernel_records`
reads a ``torch.profiler`` run by kernel name.  On the CPU it is the
host clock: a number about PyTorch's CPU kernels, never a device
metric.

Bounds use the H100 SXM's published peaks (NVIDIA data sheet, at the
700 W power limit): HBM3 at 3.35 TB/s, fp32 outside the tensor cores
at 67 TFLOP/s.
"""

from __future__ import annotations

import re
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


def host_us_per_call(fn, device: torch.device, calls: int = 50,
                     warmup: int = 3) -> float:
    """Host time of one ``fn()`` in µs: the host clock over ``calls``
    back-to-back calls with no synchronisation between them (the device
    queue is drained before and after, outside the interval).  For a
    kernel wrapper it is the cost of preparing and issuing its launches,
    which :func:`time_ms` leaves out."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (t1 - t0) / calls * 1e6


def bound_ms(n_bytes: int, flops: int) -> float:
    """Least time on the card: the larger of bytes over HBM bandwidth
    and fp32 operations over the fp32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3


def bound_by(n_bytes: int, flops: int) -> str:
    return ("bytes" if n_bytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
            else "operations")


def kernel_records(prof) -> tuple[dict, dict]:
    """(device µs, records) by kernel base name (no namespace, template
    or arguments) over a profile, summed over the ``key_averages()``
    entries of each name."""
    total, records = {}, {}
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and evt.self_device_time_total):
            m = re.search(r"(\w+)(?:<[^>]*>)?\(", evt.key)
            k = m.group(1) if m else evt.key[:40]
            total[k] = total.get(k, 0.0) + evt.self_device_time_total
            records[k] = records.get(k, 0) + evt.count
    return total, records
