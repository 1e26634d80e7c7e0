"""The native LDG partitioner (counterpart of dglke_tpu/data/native.py's
``ldg_partition_native``).

``csrc/ldg_partition.cpp`` is a copy of the JAX package's
native/ldg_partition.cpp.  It is built at first use by the host C++
compiler, with the flags of the JAX package's native/Makefile, into
``build/dglke_tpu_torch/`` at the root of the checkout, under a name
carrying the digest of the source, the compiler, the flags and the host
CPU's feature flags (``-march=native`` builds for this CPU), and loaded
with ``ctypes``.

Where the JAX package falls back to its numpy LDG when the library does
not build or load, the port raises: the numpy form draws another stream
order, so a fallback would write other partitions from the same graph and
seed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "ldg_partition.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dglke_tpu_torch"
# native/Makefile's CXXFLAGS: the same code as the JAX package's library
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread",
             "-shared")

_lib = None
_lock = threading.Lock()


def _compiler() -> str:
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: the "
                           "native LDG partitioner of dglke_tpu_torch is "
                           f"built at first use from {SOURCE}")
    return cxx


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("flags")),
                        "").encode()
    except OSError:
        return platform.processor().encode()


def library_path(cxx: str) -> Path:
    """The library built from SOURCE by ``cxx``, named by the digest of the
    source, the compiler, the flags and the CPU it is built for."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        (cxx, *CXX_FLAGS)).encode() + _cpu_flags()).hexdigest()
    return BUILD_DIR / f"ldg_partition_{digest[:16]}.so"


def load() -> ctypes.CDLL:
    """Build (once per source version) and load the library; raises
    RuntimeError with the compiler's output if the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cxx = _compiler()
        so = library_path(cxx)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                                   str(SOURCE)], capture_output=True,
                                  text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building the native LDG partitioner failed "
                    f"({cxx} exited {proc.returncode}):\n{proc.stdout}"
                    f"{proc.stderr}")
            os.replace(tmp, so)   # atomic: a concurrent build never sees half
        lib = ctypes.CDLL(str(so))
        lib.kge_ldg_partition.restype = ctypes.c_int64
        lib.kge_ldg_partition.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,
            ctypes.c_void_p]
        _lib = lib
        return lib


def ldg_partition_native(h: np.ndarray, t: np.ndarray, n_nodes: int,
                         k: int, seed: int = 0):
    """C++ LDG node streaming over the undirected graph of edges (h, t).
    Returns (assign [n_nodes] int32, edge_cut); raises ValueError on a node
    id outside [0, n_nodes) or k <= 0, and RuntimeError if the library
    cannot be built."""
    lib = load()
    h64 = np.ascontiguousarray(h, np.int64)
    t64 = np.ascontiguousarray(t, np.int64)
    if h64.shape != t64.shape or h64.ndim != 1:
        raise ValueError(f"ldg_partition: h and t must be 1-d of one length, "
                         f"got {h64.shape} and {t64.shape}")
    assign = np.empty(n_nodes, np.int32)
    cut = lib.kge_ldg_partition(h64.ctypes.data, t64.ctypes.data,
                                len(h64), n_nodes, k, seed,
                                assign.ctypes.data)
    if cut < 0:
        raise ValueError(
            "ldg_partition: invalid inputs (node id out of [0, n_nodes) "
            f"or k <= 0; n_nodes={n_nodes}, k={k})")
    return assign, int(cut)
