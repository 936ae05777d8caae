"""Native host-side preprocessing (C++ through ctypes).

Port of ``recbole_gnn_tpu/native``: the session-graph builder and the
fixed-point k-core filter of ``session_graph.cpp`` (this package's own
copy of the source).  The library is built with ``g++`` at first use
into ``recbole_gnn_tpu_torch/_build/``, named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
built once; nothing is built when the module is imported.  Where no
compiler is found or the build fails, the callers take their numpy
paths, which give the same arrays; :func:`native_available` says which
path runs.  This is host code: it runs on the CPU beside the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "session_graph.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_state: dict = {"lib": None, "tried": False}


def library_path() -> str:
    """Where the library built from ``session_graph.cpp`` lives."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libsessiongraph-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise OSError("no C++ compiler (g++) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"   # atomic: parallel builders race
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        path = library_path()
        try:
            if not os.path.isfile(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError):
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.build_session_graphs.argtypes = [
            i32p, i32p, ctypes.c_int64, ctypes.c_int32,
            i32p, i32p, i32p, i32p, i32p, i32p, ctypes.c_int32]
        lib.build_session_graphs.restype = None
        lib.kcore_filter.argtypes = [
            i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            u8p]
        lib.kcore_filter.restype = ctypes.c_int64
        _state["lib"] = lib
        return lib


def native_available() -> bool:
    """True when the C++ library is built and loaded (the callers then
    take it); False when they run their numpy paths."""
    return _load() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_session_graphs_native(seqs: np.ndarray, lengths: np.ndarray,
                                n_threads: int = 0):
    """Native equivalent of ``data/session.py``'s unique/alias/edge build.

    Returns (x, n_nodes, alias, edge_src, edge_dst, n_edges) or None if
    the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    seqs = np.ascontiguousarray(seqs, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    n, L = seqs.shape
    if lengths.shape != (n,) or (n and (lengths.min() < 0
                                        or lengths.max() > L)):
        raise ValueError("build_session_graphs_native: lengths must be "
                         f"({n},) values in [0, {L}]")
    x = np.zeros((n, L), np.int32)
    n_nodes = np.zeros(n, np.int32)
    alias = np.zeros((n, L), np.int32)
    esrc = np.zeros((n, L), np.int32)
    edst = np.zeros((n, L), np.int32)
    n_edges = np.zeros(n, np.int32)
    lib.build_session_graphs(
        _ptr(seqs, ctypes.c_int32), _ptr(lengths, ctypes.c_int32),
        ctypes.c_int64(n), ctypes.c_int32(L),
        _ptr(x, ctypes.c_int32), _ptr(n_nodes, ctypes.c_int32),
        _ptr(alias, ctypes.c_int32), _ptr(esrc, ctypes.c_int32),
        _ptr(edst, ctypes.c_int32), _ptr(n_edges, ctypes.c_int32),
        ctypes.c_int32(n_threads))
    return x, n_nodes, alias, esrc, edst, n_edges


def kcore_filter_native(users: np.ndarray, items: np.ndarray,
                        n_users: int, n_items: int,
                        u_min: int, u_max: int, i_min: int, i_max: int):
    """Native fixed-point k-core; returns the bool keep mask or None."""
    lib = _load()
    if lib is None:
        return None
    users = np.ascontiguousarray(users, dtype=np.int64)
    items = np.ascontiguousarray(items, dtype=np.int64)
    if len(users) != len(items) or (len(users) and (
            users.min() < 0 or users.max() >= n_users
            or items.min() < 0 or items.max() >= n_items)):
        raise ValueError("kcore_filter_native: ids out of range")
    keep = np.zeros(len(users), np.uint8)
    lib.kcore_filter(
        _ptr(users, ctypes.c_int64), _ptr(items, ctypes.c_int64),
        ctypes.c_int64(len(users)), ctypes.c_int64(n_users),
        ctypes.c_int64(n_items), ctypes.c_int64(u_min),
        ctypes.c_int64(u_max), ctypes.c_int64(i_min),
        ctypes.c_int64(i_max), _ptr(keep, ctypes.c_uint8))
    return keep.astype(bool)


__all__ = ["native_available", "build_session_graphs_native",
           "kcore_filter_native", "library_path"]
