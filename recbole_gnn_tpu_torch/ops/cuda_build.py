"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain
C interface and loaded with ``ctypes``.  Libraries go to
``recbole_gnn_tpu_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the source and the flags, so an edited source is rebuilt at
its next use and an unchanged one is built once.  Nothing is built
when a module is imported: the first launch builds, or a caller asks
ahead with :func:`build`, which starts one ``nvcc`` per source at once.

The kernel wrappers share the launch contract's checks here:
:func:`check_tensors` (device, dtype, rank, contiguity),
:func:`check_row_dtype` (f32 or bf16 rows) and
:func:`vec_width` (the widest vector load a row layout allows, in
elements of the row's type).  :func:`ptxas_usage` reads what each
kernel of a build uses from the compiler's ``-Xptxas=-v`` output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {home}/bin and on PATH); the "
            "port's CUDA kernels are built on the machine with the card")
    return found


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` lives: named by a
    hash of the source, the headers of ``csrc/`` it may include and the
    flags."""
    digest = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, f"{name}.cu")] + sorted(
            os.path.join(CSRC_DIR, h) for h in os.listdir(CSRC_DIR)
            if h.endswith(".cuh")):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names) -> dict[str, str]:
    """Build the named sources that are not built yet, all in parallel.

    Returns ``{name: compiler output}`` for the sources compiled by this
    call (``-Xptxas=-v`` reports registers and spills there).  Raises
    ``RuntimeError`` with the compiler's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.isfile(out):
            continue
        tmp = f"{out}.tmp.{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return logs


def ptxas_usage(log: str) -> list[dict]:
    """Each entry function of an ``-Xptxas=-v`` build log: its mangled
    name, registers per thread, and stack frame, spill store and spill
    load bytes."""
    out, cur, props = [], None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur, props = m.group(1), {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            props = dict(zip(("stack_bytes", "spill_stores", "spill_loads"),
                             map(int, m.groups())))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.append({"function": cur, "registers": int(m.group(1)),
                        **props})
            cur = None
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _loaded[name] = lib
        return lib


# the element types of the rows the kernels read (x, messages) and write
ROW_DTYPES = (torch.float32, torch.bfloat16)


def check_row_dtype(who: str, name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` holds f32 or bf16 rows, the two types every
    kernel reads itself."""
    if t.dtype not in ROW_DTYPES:
        raise TypeError(f"{who}: {name} must be one of {ROW_DTYPES}, got "
                        f"{t.dtype}")


def check_tensors(who: str, device: torch.device, specs) -> None:
    """Raise unless each ``(name, tensor, dtype, ndim)`` of ``specs`` lies
    on ``device`` with that dtype and rank, contiguous — what a kernel
    reading raw pointers needs."""
    for name, t, dtype, ndim in specs:
        if t.device != device:
            raise ValueError(f"{who}: {name} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{who}: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{who}: {name} must be {ndim}-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")


def vec_width(x: torch.Tensor) -> int:
    """Widest vector load, in elements of ``x``'s type, that every row of
    the 2-D ``x`` allows: the most elements that fill at most 16 bytes
    (4 f32, 8 bf16) and divide the row width, where the address is
    aligned to their bytes; narrower where it is not, down to 1."""
    d, ptr, size = x.shape[1], x.data_ptr(), x.element_size()
    vec = 16 // size
    while vec > 1 and (d % vec or ptr % (size * vec)):
        vec //= 2
    return vec
