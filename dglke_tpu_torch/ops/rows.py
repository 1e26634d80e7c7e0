"""Row gather and row-sparse Adagrad write-back: CUDA kernels and their
plain PyTorch versions; and the build, load and launch count shared by
every kernel module of the package.

Counterpart of dglke_tpu/ops/pallas/rows.py.  The CUDA sources are in
``csrc/`` (see the note at the top of each: what each kernel replaces, what
bounds it and what its design does about that).  Each source is built with
``nvcc`` for ``sm_90a`` at first use into ``build/dglke_tpu_torch/`` at the
root of the checkout, under a name carrying the digest of the sources and
the flags, and loaded with ``ctypes``.

Each wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel or raises.  ``launches`` counts kernel
launches per wrapper, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "rows.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dglke_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches per wrapper since the last reset_launches(); every kernel
# wrapper of the package counts here.
launches = {"gather_rows": 0, "sparse_adagrad_rows": 0, "scatter_add_rows": 0,
            "outer_adagrad_update": 0}

_libs: dict = {}       # source path -> loaded library
build_logs: dict = {}  # source file name -> nvcc's output of a build run here


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "dglke_tpu_torch are built at first use and need "
                           "the CUDA toolkit")
    return path


def _library_path(source: Path) -> Path:
    """The library of ``source``, named by the digest of its text, the
    sources and headers beside it (which it may include) and the flags."""
    text = source.read_bytes() + b"".join(
        f.read_bytes() for f in sorted(source.parent.glob("*.cu*")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}_{digest[:16]}.so"


def build_libraries(*sources: Path) -> None:
    """Compile each source whose library is not built yet: one ``nvcc`` per
    source, all started together.  Raises if any build fails."""
    todo = [(src, _library_path(src)) for src in sources]
    todo = [(src, so) for src, so in todo if not so.exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for src, so in todo:
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        log = tempfile.TemporaryFile("w+")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=log, stderr=subprocess.STDOUT,
                                text=True)
        running.append((src, so, tmp, log, proc))
    failed = []
    for src, so, tmp, log, proc in running:
        with log:
            proc.wait()
            log.seek(0)
            build_logs[src.name] = log.read()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{build_logs[src.name]}")
        else:
            os.replace(tmp, so)   # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(source: Path, signatures: dict) -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library of
    ``source``; ``signatures`` maps each C function to its (argtypes,
    restype)."""
    lib = _libs.get(source)
    if lib is None:
        build_libraries(source)
        lib = ctypes.CDLL(str(_library_path(source)))
        for name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _libs[source] = lib
    return lib


_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
SIGNATURES = {
    "dglke_gather_rows": ([_P, _INT, _I64, _I64, _P, _I64, _P, _I64, _INT,
                           _P], _INT),
    "dglke_segment_update": ([_P, _INT, _I64, _I64, _I64, _P, _P, _P, _P,
                              _I64, ctypes.c_float, _P], _INT),
}


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def _check_table(table: torch.Tensor, name: str) -> int:
    if table.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: table dtype must be float32 or bfloat16, "
                        f"got {table.dtype}")
    if table.dim() != 2 or table.stride(1) != 1:
        raise ValueError(f"{name}: table must be 2-D with unit column stride")
    return _DTYPE_CODE[table.dtype]


def check_ids(ids: torch.Tensor, device, name: str) -> None:
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: ids must be a 1-D int32/int64 tensor")
    if ids.device != device:
        raise ValueError(f"{name}: ids on {ids.device}, table on {device}")


# ---------------------------------------------------------------------------
# K1: row gather (replaces dglke_tpu/ops/pallas/rows.py:gather_rows)


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor,
                      dim: int) -> torch.Tensor:
    """out[i] = float32(table[ids[i], :dim])."""
    return table[ids.long(), :dim].to(torch.float32)


GATHER_SHAPES = ("warp", "wide")
# Rows of at least this many elements take the wide shape: measured on the
# card by chip_smoke.py's sweep of both shapes (PERF.md, section 6).
GATHER_WIDE_MIN = 2048
_WIDE_CHUNK = 2048        # row elements per block of the wide shape, at least
_MAX_ROWS = (1 << 31) - 1   # gridDim.x
_MAX_CHUNKS = 65535        # gridDim.y of the wide shape


def gather_shape(dim: int) -> str:
    """The K1 launch shape for rows of ``dim`` elements: one warp per row
    ("warp") below GATHER_WIDE_MIN, blocks over (row, chunk) ("wide") from
    there."""
    return "wide" if dim >= GATHER_WIDE_MIN else "warp"


def launch_gather(table: torch.Tensor, ids: torch.Tensor, dim: int,
                  shape: str) -> torch.Tensor:
    """Launch K1 on CUDA tensors in the given shape (arguments checked by
    the caller); counts one launch of gather_rows."""
    if shape not in GATHER_SHAPES:
        raise ValueError(f"gather_rows: shape {shape!r} not in "
                         f"{GATHER_SHAPES}")
    ids32 = ids.to(torch.int32).contiguous()
    n = ids32.shape[0]
    out = torch.empty((n, dim), dtype=torch.float32, device=table.device)
    if n == 0:
        return out
    if n > _MAX_ROWS or (shape == "wide"
                         and -(-dim // _WIDE_CHUNK) > _MAX_CHUNKS):
        raise ValueError(f"gather_rows: {n} rows of {dim} exceed the "
                         f"{shape} launch's grid")
    lib = load_library(SOURCE, SIGNATURES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.dglke_gather_rows(
            table.data_ptr(), _DTYPE_CODE[table.dtype], table.shape[0],
            table.stride(0), ids32.data_ptr(), n, out.data_ptr(), dim,
            int(shape == "wide"), stream)
    check_launch(err, "gather_rows")
    launches["gather_rows"] += 1
    return out


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                dim: int | None = None) -> torch.Tensor:
    """[E, >=dim] table (fp32 or bf16), [N] ids -> [N, dim] float32 rows.

    Replaces dglke_tpu/ops/pallas/rows.py:gather_rows.  Bound by bytes:
    each row is read once and written once in fp32.  16-byte loads; one
    warp per narrow row, many blocks per wide row (gather_shape)."""
    dim = table.shape[1] if dim is None else dim
    _check_table(table, "gather_rows")
    if not 0 < dim <= table.shape[1]:
        raise ValueError(f"gather_rows: dim {dim} outside the table's "
                         f"width {table.shape[1]}")
    check_ids(ids, table.device, "gather_rows")
    if table.device.type == "cpu":
        return gather_rows_plain(table, ids, dim)
    return launch_gather(table, ids, dim, gather_shape(dim))


# ---------------------------------------------------------------------------
# K2: sorted-segment row update (replaces rows.py:scatter_add_rows, grown
# into the whole ops/embedding.py:sparse_adagrad_update)


def _add_rows(table: torch.Tensor, ids: torch.Tensor,
              delta: torch.Tensor) -> None:
    """table[ids] += delta per occurrence, in place.  A bf16 table's touched
    rows are summed in fp32 and rounded once, as the kernel does."""
    if table.dtype == torch.float32:
        table.index_add_(0, ids, delta)
        return
    uniq, inv = torch.unique(ids, return_inverse=True)
    acc = table[uniq].float().index_add_(0, inv, delta)
    table[uniq] = acc.to(table.dtype)


def sparse_adagrad_plain(emb: torch.Tensor, state_sum: torch.Tensor,
                         ids: torch.Tensor, grads: torch.Tensor,
                         lr: float) -> None:
    """Per-occurrence row-sparse Adagrad, in place: state_sum[ids] +=
    mean(g^2); std = sqrt(state_sum[ids]) + 1e-10 read after all adds;
    emb[ids] += -lr * g / std."""
    ids = ids.long()
    state_sum.index_add_(0, ids, torch.mean(grads * grads, dim=1))
    std = torch.sqrt(state_sum[ids]) + 1e-10
    _add_rows(emb, ids, (-lr) * grads / std[:, None])


def scatter_add_plain(table: torch.Tensor, ids: torch.Tensor,
                      delta: torch.Tensor) -> None:
    """table[ids] += delta in place, duplicates summed."""
    _add_rows(table, ids.long(), delta)


def _check_update(emb, state_sum, ids, grads, name) -> int:
    code = _check_table(emb, name)
    check_ids(ids, emb.device, name)
    n = ids.shape[0]
    if grads.dtype != torch.float32 or not grads.is_contiguous():
        raise TypeError(f"{name}: rows must be contiguous float32")
    if grads.shape != (n, emb.shape[1]) or grads.device != emb.device:
        raise ValueError(f"{name}: rows {tuple(grads.shape)} on "
                         f"{grads.device} do not match {n} ids and the "
                         f"table {tuple(emb.shape)} on {emb.device}")
    if state_sum is not None and (
            state_sum.dtype != torch.float32 or not state_sum.is_contiguous()
            or state_sum.shape != (emb.shape[0],)
            or state_sum.device != emb.device):
        raise ValueError(f"{name}: state_sum must be a contiguous float32 "
                         f"[{emb.shape[0]}] tensor on {emb.device}")
    return code


def _segment_update(code, emb, state_sum, ids, grads, lr, name) -> bool:
    """Launch the sorted-segment kernel; False when there was nothing to
    launch (no ids)."""
    n = ids.shape[0]
    if n == 0:
        return False
    # Preprocessing, not the update: a stable sort groups equal ids into
    # segments, so the kernel sums duplicates in a fixed order (the
    # counterpart of the JAX package computing window_conflicts outside
    # its kernel).
    sids, order = torch.sort(ids.to(torch.int32), stable=True)
    lib = load_library(SOURCE, SIGNATURES)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = lib.dglke_segment_update(
            emb.data_ptr(), code, emb.shape[0], emb.stride(0), emb.shape[1],
            None if state_sum is None else state_sum.data_ptr(),
            sids.data_ptr(), order.data_ptr(), grads.data_ptr(), n,
            float(lr), stream)
    check_launch(err, name)
    return True


def sparse_adagrad_rows(emb: torch.Tensor, state_sum: torch.Tensor,
                        ids: torch.Tensor, grads: torch.Tensor,
                        lr: float) -> None:
    """Row-sparse Adagrad, IN PLACE on ``emb`` and ``state_sum`` (the JAX
    function returns new arrays).  emb: [E, D] fp32/bf16; state_sum: [E]
    fp32; ids: [N] with duplicates; grads: [N, D] contiguous fp32.

    Replaces dglke_tpu/ops/pallas/rows.py:scatter_add_rows, grown into the
    whole dglke_tpu/ops/embedding.py:sparse_adagrad_update.  Bound by bytes:
    the gradient rows are read once and each touched table row is read and
    written once.  On the card each unique id's segment is summed in a
    fixed order and written once, so the result does not depend on the
    order blocks run in: state_sum[u] += sum mean(g^2); emb[u] += -lr *
    sum(g) / (sqrt(state_sum[u]) + 1e-10), rounded once to the table
    dtype."""
    code = _check_update(emb, state_sum, ids, grads, "sparse_adagrad_rows")
    if emb.device.type == "cpu":
        sparse_adagrad_plain(emb, state_sum, ids, grads, lr)
    elif _segment_update(code, emb, state_sum, ids, grads, lr,
                         "sparse_adagrad_rows"):
        launches["sparse_adagrad_rows"] += 1


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     delta: torch.Tensor) -> None:
    """table[ids] += delta IN PLACE with duplicates summed exactly (delta:
    [N, D] contiguous fp32) — what the TPU kernel computes, on the same
    core as sparse_adagrad_rows."""
    code = _check_update(table, None, ids, delta, "scatter_add_rows")
    if table.device.type == "cpu":
        scatter_add_plain(table, ids, delta)
    elif _segment_update(code, table, None, ids, delta, 0.0,
                         "scatter_add_rows"):
        launches["scatter_add_rows"] += 1
