"""Row gather, id grouping and row-sparse Adagrad write-back: CUDA kernels
and their plain PyTorch versions; and the build, load and launch count
shared by every kernel module of the package.

Counterpart of dglke_tpu/ops/pallas/rows.py.  The CUDA sources are in
``csrc/`` (see the note at the top of each: what each kernel replaces, what
bounds it and what its design does about that).  Each source is built with
``nvcc`` for ``sm_90a`` at first use into ``build/dglke_tpu_torch/`` at the
root of the checkout, under a name carrying the digest of the sources and
the flags, and loaded with ``ctypes``.

Each wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches its kernel or raises.  ``launches`` counts kernel
launches per wrapper, so a run can show that it went through the kernels.

Host-resident tables (--mix_cpu_gpu): ``map_host`` pins a numpy table in
place and maps it into the card's address space (``host_zeros`` places
one on 2 MB boundaries).  K1 and K2 take that CPU table with ids (and
gradient rows) on the card, and read and write it at its device-side
address: K1 in a launch shape of its own (gather_shape), K2 from the rows
K1 gathered at the same ids, so only the batch's rows cross the host link.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import mmap
import os
import shutil
import subprocess
import tempfile
import weakref
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "rows.cu"
GROUP_SOURCE = CSRC / "group_ids.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dglke_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches per wrapper since the last reset_launches(); every kernel
# wrapper of the package counts here.  The grouping counts one a batch:
# "group_ids" on its one-block route, "group_ids_tiles" on its tiles route
# (each such count is one call of 4 + passes kernels).  A K1 launch that
# also sums |x|^p (gather_rows_pow_sum's fused route) counts under
# gather_rows and under gather_rows_pow_sum; one that also forms RESCAL's
# matrix-vector product (gather_rows_matvec's fused route) under
# gather_rows_matvec and gather_rows, and under gather_rows_pow_sum when it
# sums.  TransE_l2's fused loss (ops/transe_l2.py) counts its two kernels a
# call under transe_l2_loss.
launches = {"gather_rows": 0, "gather_rows_pow_sum": 0,
            "gather_rows_matvec": 0, "group_ids": 0,
            "group_ids_tiles": 0, "sparse_adagrad_rows": 0,
            "scatter_add_rows": 0, "outer_adagrad_update": 0,
            "transe_l2_loss": 0}

_libs: dict = {}       # source path -> loaded library
build_logs: dict = {}  # source file name -> nvcc's output of a build run here


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def take_launches(before: dict) -> dict:
    """The launches counted since ``before`` (a copy of ``launches``), taken
    back out of ``launches``, which returns to ``before``.  A CUDA graph's
    capture runs the wrappers once and launches nothing: its counts are
    taken out, and add_launches puts them back once for each replay."""
    counted = {k: launches[k] - before[k] for k in launches}
    launches.update(before)
    return counted


def add_launches(counts: dict) -> None:
    """Count ``counts`` (launches by wrapper), as one replay launches."""
    for k, n in counts.items():
        launches[k] += n


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
    "dglke_gather_rows_mapped": ([_P, _INT, _I64, _I64, _P, _I64, _P, _I64,
                                  _I64, _P], _INT),
    "dglke_gather_rows_pow_sum": ([_P, _I64, _I64, _P, _I64, _P, _I64, _INT,
                                   _P, _I64, _P], _INT),
    "dglke_gather_rows_matvec": ([_P, _I64, _I64, _P, _I64, _P, _I64, _P,
                                  _I64, _INT, _INT, _I64, _I64, _P, _P, _P,
                                  _P], _INT),
    "dglke_segment_update": ([_P, _INT, _I64, _I64, _I64, _P, _P, _P, _P, _P,
                              _P, _P, _I64, ctypes.c_float, _INT, _INT, _P,
                              _P], _INT),
    "dglke_host_register": ([_P, _I64, ctypes.POINTER(_P)], _INT),
    "dglke_host_unregister": ([_P], _INT),
}
GROUP_SIGNATURES = {
    "dglke_group_ids": ([_P, _INT, _I64, _I64, _INT, _INT, _P, _P, _P, _P, _P,
                         _P, _P], _INT),
    "dglke_group_ids_tiles": ([_P, _INT, _I64, _I64, _INT, _P, _P, _P, _P, _P,
                               _P, _P, _I64, _P], _INT),
}
_MAX_INT32 = (1 << 31) - 1


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
# Host memory mapped for the card (host-resident tables, --mix_cpu_gpu)


# Host address -> (bytes, device-side address) of each range map_host
# registered and has not released yet.
_mapped: dict = {}


def map_host(arr: np.ndarray) -> torch.Tensor:
    """Pin a C-contiguous, writable numpy array in place and map it into the
    card's address space (csrc/rows.cu:dglke_host_register); returns the CPU
    tensor that shares its memory.  gather_rows and sparse_adagrad_rows take
    that tensor as their table with ids on the card, and reach it at its
    device-side address.  The pages are unpinned when the array is freed.
    Pageable memory registered in place, not torch's pinned allocator,
    which may round a request up to a power of two."""
    if not (arr.flags.c_contiguous and arr.flags.writeable) or arr.nbytes == 0:
        raise ValueError("map_host: the array must be C-contiguous, writable "
                         "and not empty")
    lib = load_library(SOURCE, SIGNATURES)
    torch.cuda.init()
    host = arr.ctypes.data
    dev = _P()
    err = lib.dglke_host_register(host, arr.nbytes, ctypes.byref(dev))
    if err != 0:
        raise RuntimeError(f"map_host: cudaHostRegister of {arr.nbytes} bytes "
                           f"failed with error {err}")
    _mapped[host] = (arr.nbytes, dev.value)
    # Runs before numpy frees the buffer; not at exit, when the CUDA
    # context may already be gone (the pages go with the process).
    weakref.finalize(arr, _unmap_host, lib, host).atexit = False
    return torch.from_numpy(arr)


HUGE_PAGE_BYTES = 2 << 20
_THP_MODE = Path("/sys/kernel/mm/transparent_hugepage/enabled")


def host_zeros(shape, dtype=np.float32) -> np.ndarray:
    """A zeroed, C-contiguous, writable array in an anonymous mapping of its
    own, its start aligned to 2 MB and advised MADV_HUGEPAGE before its
    first touch.  Rows whose bytes are a multiple of 128 then start on a
    128-byte line, so the mapped shape's windows read no line twice; where
    the host's kernel offers transparent huge pages it backs the array with
    2 MB pages, one translation where 4 KB pages need 512.  map_host takes
    it as any array; the mapping is released with the array."""
    dtype = np.dtype(dtype)
    n_bytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    m = mmap.mmap(-1, n_bytes + HUGE_PAGE_BYTES,
                  flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    advice = getattr(mmap, "MADV_HUGEPAGE", None)
    if advice is not None:
        try:
            m.madvise(advice)
        except OSError:       # a kernel without transparent huge pages
            pass
    offset = -np.frombuffer(m, np.uint8, 1).ctypes.data % HUGE_PAGE_BYTES
    return np.frombuffer(m, dtype, n_bytes // dtype.itemsize,
                         offset).reshape(shape)


def host_pages(arrays) -> str:
    """What pages back ``arrays`` (host memory of this process): the share
    /proc/self/smaps counts as AnonHugePages, and the host's transparent
    huge page mode."""
    try:
        mode = _THP_MODE.read_text().split("[")[1].split("]")[0]
    except (OSError, IndexError):
        mode = None
    spans = [(a.ctypes.data, a.ctypes.data + a.nbytes) for a in arrays]
    total = sum(hi - lo for lo, hi in spans)
    huge, inside = 0, False
    try:
        with open("/proc/self/smaps") as f:
            for line in f:
                head = line.split(maxsplit=1)[0] if line.strip() else ""
                if "-" in head and not head.endswith(":"):
                    lo, hi = (int(x, 16) for x in head.split("-"))
                    inside = any(lo < b and a < hi for a, b in spans)
                elif inside and head == "AnonHugePages:":
                    huge += int(line.split()[1]) * 1024
    except OSError:
        pass
    share = f"{100 * min(huge, total) / max(total, 1):.1f}% in 2 MB pages"
    if mode is None:
        return share + " (this host offers no transparent huge pages)"
    return share + f" (transparent huge pages: {mode})"


def _unmap_host(lib, host: int) -> None:
    if _mapped.pop(host, None) is not None:
        lib.dglke_host_unregister(host)


def mapped_address(t: torch.Tensor):
    """The device-side address of a CPU tensor's data when all of it lies in
    a range map_host registered, else None."""
    if t.device.type != "cpu" or t.numel() == 0:
        return None
    p = t.data_ptr()
    end = p + t.element_size() * (1 + sum(
        (n - 1) * st for n, st in zip(t.shape, t.stride())))
    for host, (n_bytes, dev) in _mapped.items():
        if host <= p and end <= host + n_bytes:
            return dev + (p - host)
    return None


def sync_mapped() -> None:
    """Wait for the card before the host reads a mapped table: K2 writes it
    asynchronously on the current stream.  Nothing to wait for when no
    table is mapped."""
    if _mapped:
        torch.cuda.synchronize()


def _reach(t: torch.Tensor, device, name: str, what: str) -> int:
    """The address at which a kernel on ``device`` reaches ``t``: its data
    pointer when it lies there, its device-side address when it is a CPU
    tensor in mapped memory and ``device`` a card.  Anything else raises."""
    if t.device == device:
        return t.data_ptr()
    addr = mapped_address(t) if device.type == "cuda" else None
    if addr is None:
        raise ValueError(f"{name}: {what} on {t.device}, ids on {device} (a "
                         f"CPU table reaches the card only through map_host)")
    return addr


# ---------------------------------------------------------------------------
# K1: row gather (replaces dglke_tpu/ops/pallas/rows.py:gather_rows)


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor,
                      dim: int) -> torch.Tensor:
    """out[i] = float32(table[ids[i], :dim])."""
    return table[ids.long(), :dim].to(torch.float32)


# "wide" copies aligned fp32 rows with the TMA engine; "mapped" reads whole
# 128-byte lines into shared memory (gather_rows_mapped).
GATHER_SHAPES = ("warp", "wide", "mapped")
# Rows of at least this many elements take the wide shape: measured on the
# card by chip_smoke.py's sweep of both shapes (PERF.md, section 6).
GATHER_WIDE_MIN = 2048
_WIDE_CHUNK = 2048        # row elements per block of the wide shape, at least
_MAX_ROWS = (1 << 31) - 1   # gridDim.x
_MAX_CHUNKS = 65535        # gridDim.y of the wide shape

# The mapped shape's windows (csrc/rows.cu: kLine, kMapSlot): the SMs reach
# host memory in requests of whole 128-byte lines, and a window of up to
# 16 lines fits a warp's slot of shared memory.
LINE_BYTES = 128
MAPPED_SLOT_BYTES = 2048


def line_window(offset: int, width: int, elem_bytes: int = 4):
    """The 128-byte lines that hold ``width`` elements of ``elem_bytes``
    starting at byte ``offset``: (first line, line count, shift), the
    shift being the first element's byte offset in the first line."""
    first = offset // LINE_BYTES
    end = -(-(offset + width * elem_bytes) // LINE_BYTES)
    return first, end - first, offset - first * LINE_BYTES


def mapped_chunk(dim: int, elem_bytes: int = 4) -> int:
    """Row elements one window of the mapped shape covers: the row when it
    fits, else the most whose window fits MAPPED_SLOT_BYTES at the worst
    shift, a whole number of lines (so the chunks of a row on a line
    share its shift)."""
    chunk = min(dim, (MAPPED_SLOT_BYTES - LINE_BYTES) // elem_bytes)
    worst = line_window(LINE_BYTES - elem_bytes, chunk, elem_bytes)[1]
    if worst * LINE_BYTES > MAPPED_SLOT_BYTES:
        raise ValueError(f"mapped_chunk: {chunk} elements need {worst} lines")
    return chunk


def gather_shape(dim: int, mapped: bool = False) -> str:
    """The K1 launch shape for rows of ``dim`` elements: one warp per row
    ("warp") below GATHER_WIDE_MIN, blocks over (row, chunk) ("wide") from
    there; "mapped" (whole lines, mapped_chunk elements a window) for a
    table in mapped host memory, at every width.  On an NVIDIA H100 80GB
    HBM3 at 700 W, on fresh ids each call, it took 0.1834 ms for 3,000 ids
    x 400 fp32 (blocks over (row, chunk) with the threads' own loads
    0.1929, the card's shape 0.2154) and 23.92 ms for 1,000 of TransR's
    160,000-wide rows (24.83 and 24.86); PERF.md, section 6.  The same
    table in numpy's own memory, its rows off the 128-byte lines, took
    0.2175 ms: host_zeros places tables on them."""
    if mapped:
        return "mapped"
    return "wide" if dim >= GATHER_WIDE_MIN else "warp"


def launch_gather(table: torch.Tensor, ids: torch.Tensor, dim: int,
                  shape: str, address: int | None = None) -> torch.Tensor:
    """Launch K1 on the ids' card in the given shape (arguments checked by
    the caller), reading the table at ``address`` (its mapped address) or
    at its own; counts one launch of gather_rows."""
    if shape not in GATHER_SHAPES:
        raise ValueError(f"gather_rows: shape {shape!r} not in "
                         f"{GATHER_SHAPES}")
    ids32 = ids.to(torch.int32).contiguous()
    n = ids32.shape[0]
    out = torch.empty((n, dim), dtype=torch.float32, device=ids.device)
    if n == 0:
        return out
    if n > _MAX_ROWS or (shape != "warp"
                         and -(-dim // _WIDE_CHUNK) > _MAX_CHUNKS):
        raise ValueError(f"gather_rows: {n} rows of {dim} exceed the "
                         f"{shape} launch's grid")
    lib = load_library(SOURCE, SIGNATURES)
    args = (table.data_ptr() if address is None else address,
            _DTYPE_CODE[table.dtype], table.shape[0], table.stride(0),
            ids32.data_ptr(), n, out.data_ptr(), dim)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        if shape == "mapped":
            err = lib.dglke_gather_rows_mapped(
                *args, mapped_chunk(dim, table.element_size()), stream)
        else:
            err = lib.dglke_gather_rows(*args, GATHER_SHAPES.index(shape),
                                        stream)
    check_launch(err, "gather_rows")
    launches["gather_rows"] += 1
    return out


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                dim: int | None = None) -> torch.Tensor:
    """[E, >=dim] table (fp32 or bf16), [N] ids -> [N, dim] float32 rows.

    Replaces dglke_tpu/ops/pallas/rows.py:gather_rows.  Bound by bytes:
    each row is read once and written once in fp32.  16-byte loads; one
    warp per narrow row, many blocks per wide row (gather_shape).  A CPU
    table mapped by map_host, with ids on the card, is read in place over
    the host link into rows on the card."""
    dim = table.shape[1] if dim is None else dim
    _check_table(table, "gather_rows")
    if not 0 < dim <= table.shape[1]:
        raise ValueError(f"gather_rows: dim {dim} outside the table's "
                         f"width {table.shape[1]}")
    if table.device.type == "cpu" and ids.device.type == "cuda":
        check_ids(ids, ids.device, "gather_rows")
        address = _reach(table, ids.device, "gather_rows", "table")
        return launch_gather(table, ids, dim, gather_shape(dim, mapped=True),
                             address)
    check_ids(ids, table.device, "gather_rows")
    if table.device.type == "cpu":
        return gather_rows_plain(table, ids, dim)
    return launch_gather(table, ids, dim, gather_shape(dim))


# The exponents whose |x|^p K1's wide bulk copy sums as it copies.
POW_SUM_EXPONENTS = (1, 2, 3)


def pow_sum_plain(rows: torch.Tensor, p: int) -> torch.Tensor:
    """sum |x|^p over ``rows``: the regularization value before its
    coefficient (models/loss.py:regularization sums it over its tensors)."""
    return torch.sum(torch.abs(rows) ** p)


def _bulk_wide(table: torch.Tensor, ids: torch.Tensor, dim: int) -> bool:
    """An fp32 table on the card whose rows take the wide shape and the bulk
    copy (its address and pitch on 16-byte boundaries, ``dim`` a multiple
    of four), and at least one id."""
    return (table.device.type == "cuda" and table.dtype == torch.float32
            and gather_shape(dim) == "wide" and dim % 4 == 0
            and table.stride(0) % 4 == 0 and table.data_ptr() % 16 == 0
            and ids.shape[0] > 0)


def fused_pow_sum(table: torch.Tensor, ids: torch.Tensor, dim: int,
                  p: int) -> bool:
    """Whether K1 sums |x|^p for gather_rows_pow_sum: _bulk_wide rows and p
    in POW_SUM_EXPONENTS."""
    return p in POW_SUM_EXPONENTS and _bulk_wide(table, ids, dim)


def gather_rows_pow_sum(table: torch.Tensor, ids: torch.Tensor, p: int,
                        dim: int | None = None):
    """gather_rows(table, ids, dim) and the 0-d fp32 sum of |x|^p over the
    rows it returns, duplicates counted: the regularization value of the
    rows before its coefficient.

    Where fused_pow_sum holds, K1's wide bulk copy sums the rows as it
    copies them (csrc/rows.cu:dglke_gather_rows_pow_sum): each |x|^p in
    fp32 as torch.pow takes it, added in fp64 into a partial a (row,
    chunk); the partials are summed in fp64 a row, then over the rows,
    and rounded to fp32 once.  Every order is fixed for a shape, so the
    value is the same on every launch.  (Summed at once, the partials
    take a single block: ~30 us on an H100 at 1,000 rows of 250,000.)
    Every other table (on the CPU, in mapped host memory, bf16, narrow or
    unaligned rows) takes gather_rows and pow_sum_plain on its rows.  A
    fused launch counts one launch of gather_rows and one of
    gather_rows_pow_sum."""
    dim = table.shape[1] if dim is None else dim
    if not fused_pow_sum(table, ids, dim, p):
        rows = gather_rows(table, ids, dim)
        return rows, pow_sum_plain(rows, p)
    _check_table(table, "gather_rows_pow_sum")
    check_ids(ids, table.device, "gather_rows_pow_sum")
    ids32 = ids.to(torch.int32).contiguous()
    n = ids32.shape[0]
    if dim > table.shape[1] or n > _MAX_ROWS or (
            -(-dim // _WIDE_CHUNK) > _MAX_CHUNKS):
        raise ValueError(f"gather_rows_pow_sum: {n} rows of {dim} outside "
                         f"the table's width {table.shape[1]} or the wide "
                         f"launch's grid")
    out = torch.empty((n, dim), dtype=torch.float32, device=ids.device)
    partials = torch.empty((n, -(-dim // _WIDE_CHUNK)), dtype=torch.float64,
                           device=ids.device)
    lib = load_library(SOURCE, SIGNATURES)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        err = lib.dglke_gather_rows_pow_sum(
            table.data_ptr(), table.shape[0], table.stride(0),
            ids32.data_ptr(), n, out.data_ptr(), dim, p, partials.data_ptr(),
            partials.numel(), stream)
    check_launch(err, "gather_rows_pow_sum")
    launches["gather_rows"] += 1
    launches["gather_rows_pow_sum"] += 1
    return out, partials.sum(dim=1).sum().float()


# K1's wide pass with RESCAL's product (csrc/rows.cu: kMatvecStage,
# kMatvecMaxHidden): a stage buffer holds MATVEC_STAGE fp32 elements, a
# thread at most MATVEC_MAX_HIDDEN / 128 columns.  A block takes a band of
# about MATVEC_BAND_ROWS[head] matrix rows: R t (head) narrow bands, whose
# blocks read each row's repeats in the batch closer together, so more of
# them in L2; v^T R wide ones, each of which writes a [hidden] fp64 partial.
# The band sizes are the fastest of a sweep on an NVIDIA H100 80GB HBM3
# at 700 W (1,000 ids, 687 distinct, x 500 x 500 fp32 with the sum of
# |x|^3): R t in bands of 8 rows 0.5923 ms and v^T R in bands of 96 0.6707,
# partials' sum included, where the sum alone took about 0.60; v^T R in
# bands of 8 took ~0.82 (PERF.md, section 6).
MATVEC_STAGE = 2048
MATVEC_MAX_HIDDEN = 1024
MATVEC_BAND_ROWS = {True: 8, False: 96}


def matvec_rows(hidden: int, head: bool) -> tuple:
    """(stage rows, band rows) of gather_rows_matvec's launch at ``hidden``:
    the most matrix rows that fit a stage and hold a multiple of four
    elements (so that every stage starts on 16 bytes), and the band of the
    whole stages nearest MATVEC_BAND_ROWS[head] (at least one)."""
    align = 4 // math.gcd(hidden, 4)
    stage = MATVEC_STAGE // hidden // align * align
    return stage, stage * max(1, round(MATVEC_BAND_ROWS[head] / stage))


def matvec_plain(rows: torch.Tensor, vecs: torch.Tensor,
                 head: bool) -> torch.Tensor:
    """Each row of ``rows`` [N, hidden * hidden] viewed as a matrix R
    [hidden, hidden], times its vector of ``vecs`` [N, hidden]: R v when
    ``head`` (R t, RESCAL's head-corrupt steps), else v^T R (h^T R)."""
    hidden = vecs.shape[1]
    rmat = rows.reshape(rows.shape[0], hidden, hidden)
    if head:
        return torch.bmm(rmat, vecs[:, :, None])[:, :, 0]
    return torch.bmm(vecs[:, None, :], rmat)[:, 0, :]


def fused_matvec(table: torch.Tensor, ids: torch.Tensor, vecs: torch.Tensor,
                 dim: int, p: int) -> bool:
    """Whether K1 forms RESCAL's product for gather_rows_matvec: _bulk_wide
    rows of hidden x hidden elements, hidden at most MATVEC_MAX_HIDDEN,
    fp32 vectors [N, hidden] with unit column stride on the table's card,
    and p 0 (no sum) or in POW_SUM_EXPONENTS."""
    hidden = vecs.shape[-1]
    return (p in (0,) + POW_SUM_EXPONENTS and hidden * hidden == dim
            and hidden <= MATVEC_MAX_HIDDEN and vecs.dim() == 2
            and vecs.shape[0] == ids.shape[0]
            and vecs.dtype == torch.float32 and vecs.stride(1) == 1
            and vecs.device == table.device and _bulk_wide(table, ids, dim))


def gather_rows_matvec(table: torch.Tensor, ids: torch.Tensor,
                       vecs: torch.Tensor, head: bool, p: int,
                       dim: int | None = None):
    """RESCAL's relation gather: (rows, pow_sum, tmp) where rows is
    gather_rows(table, ids, dim); pow_sum the 0-d fp32 sum of |x|^p over
    them as gather_rows_pow_sum gives it, or None for p = 0; and tmp
    matvec_plain(rows, vecs, head), each row a [hidden, hidden] matrix
    times its edge's entity vector.

    Where fused_matvec holds, one K1 launch copies the rows and forms tmp
    (and the sum) from the bytes it holds in shared memory
    (csrc/rows.cu:dglke_gather_rows_matvec), in place of a second read of
    the [N, dim] copy: each product of two fp32 values exact in fp64,
    summed in fp64 in a fixed order and rounded to fp32 once (v^T R: an
    fp64 partial a band, summed over the bands here); the sum's partials
    a band, summed as gather_rows_pow_sum sums its chunks'.  The same bits
    on every launch.  Every other table (on the CPU, in mapped host
    memory, bf16, unaligned or other rows) takes gather_rows_pow_sum (p >
    0) or gather_rows, then matvec_plain.  A fused launch counts one
    launch of gather_rows_matvec and of gather_rows, and of
    gather_rows_pow_sum for p > 0."""
    dim = table.shape[1] if dim is None else dim
    if not fused_matvec(table, ids, vecs, dim, p):
        if p > 0:
            rows, pow_sum = gather_rows_pow_sum(table, ids, p, dim)
        else:
            rows, pow_sum = gather_rows(table, ids, dim), None
        return rows, pow_sum, matvec_plain(rows, vecs, head)
    _check_table(table, "gather_rows_matvec")
    check_ids(ids, table.device, "gather_rows_matvec")
    ids32 = ids.to(torch.int32).contiguous()
    n, hidden = ids32.shape[0], vecs.shape[1]
    if dim > table.shape[1] or n > _MAX_ROWS:
        raise ValueError(f"gather_rows_matvec: {n} rows of {dim} outside "
                         f"the table's width {table.shape[1]} or the "
                         f"launch's grid")
    stage, band = matvec_rows(hidden, head)
    bands = -(-hidden // band)
    dev = ids.device
    out = torch.empty((n, dim), dtype=torch.float32, device=dev)
    tmp, partials = (
        (torch.empty((n, hidden), dtype=torch.float32, device=dev), None)
        if head else
        (None, torch.empty((n, bands, hidden), dtype=torch.float64,
                           device=dev)))
    pow_partials = (torch.empty((n, bands), dtype=torch.float64, device=dev)
                    if p > 0 else None)
    lib = load_library(SOURCE, SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.dglke_gather_rows_matvec(
            table.data_ptr(), table.shape[0], table.stride(0),
            ids32.data_ptr(), n, out.data_ptr(), hidden, vecs.data_ptr(),
            vecs.stride(0), int(head), p, stage, band,
            None if tmp is None else tmp.data_ptr(),
            None if partials is None else partials.data_ptr(),
            None if pow_partials is None else pow_partials.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "gather_rows_matvec")
    launches["gather_rows"] += 1
    launches["gather_rows_matvec"] += 1
    if tmp is None:
        tmp = partials.sum(dim=1).float()
    pow_sum = None
    if pow_partials is not None:
        launches["gather_rows_pow_sum"] += 1
        pow_sum = pow_partials.sum(dim=1).sum().float()
    return out, pow_sum, tmp


# ---------------------------------------------------------------------------
# Id grouping: the stable sort of K2's and K3's ids into segments of equal
# ids (the counterpart of the conflict flags the JAX package computes
# outside its kernel, dglke_tpu/ops/pallas/rows.py:window_conflicts); on
# the card a kernel of csrc/group_ids.cu at every batch size


# The grouping (csrc/group_ids.cu).  Up to GROUP_BLOCK_MAX ids: one block
# of GROUP_THREADS threads, each holding the fewest of GROUP_ITEMS ids that
# cover the batch.  Above: the tiles route, tiles of GROUP_BLOCK_MAX ids
# sorted a block each, merged pairwise, then the segments listed by blocks
# of GROUP_SEG_IDS ranks.
GROUP_THREADS = 256
GROUP_ITEMS = (1, 2, 4, 8, 12, 16, 24, 32)
GROUP_BLOCK_MAX = GROUP_THREADS * GROUP_ITEMS[-1]
GROUP_SEG_IDS = 2048


@dataclass(frozen=True)
class GroupPlan:
    """How a batch of ids is grouped; both routes sort the ``bits`` that
    n_rows - 1 needs (at least one).  route "block": one block, ``items``
    ids a thread.  route "tiles": ``tiles`` sorted runs, merged in
    ``passes`` passes."""
    route: str
    bits: int
    items: int = 0
    tiles: int = 0
    passes: int = 0

    @property
    def kernels(self) -> int:
        """The CUDA kernels one grouping launches: the tile sort, the merge
        passes and three for the segments on the tiles route."""
        return 1 if self.route == "block" else 4 + self.passes


def plan_group(n: int, n_rows: int) -> GroupPlan:
    """The grouping of ``n`` ids into a table of ``n_rows`` rows."""
    if not 0 <= n <= _MAX_INT32 or not 0 < n_rows <= _MAX_INT32 + 1:
        raise ValueError(f"plan_group: {n} ids into {n_rows} rows")
    bits = max(1, (n_rows - 1).bit_length())
    if n > GROUP_BLOCK_MAX:
        tiles = -(-n // GROUP_BLOCK_MAX)
        return GroupPlan("tiles", bits, tiles=tiles,
                         passes=(tiles - 1).bit_length())
    items = next(k for k in GROUP_ITEMS if k * GROUP_THREADS >= n)
    return GroupPlan("block", bits, items)


def group_scratch_slots(n: int) -> int:
    """int32 slots of scratch the tiles route takes for ``n`` ids: two runs
    of (id, position) pairs and a head count for each segment block."""
    return 4 * n + -(-n // GROUP_SEG_IDS)


@dataclass(frozen=True)
class Grouping:
    """Ids grouped into segments of equal ids, in one int32 buffer of 6n + 2
    slots on the ids' device: ``sids`` and ``order``, exactly what
    torch.sort(ids.int32, stable=True) returns; ``heads[k]`` the position of
    segment k's first id, with heads[count] = n; ``seg_ids[k]`` its id;
    ``seg_first[k]`` the position in ids of its first occurrence
    (order[heads[k]]); ``count`` the number of segments.  Entries of heads,
    seg_ids and seg_first past the count are unspecified."""
    buf: torch.Tensor
    n: int

    @property
    def order(self) -> torch.Tensor:
        return self.buf[:2 * self.n].view(torch.int64)

    @property
    def sids(self) -> torch.Tensor:
        return self.buf[2 * self.n:3 * self.n]

    @property
    def heads(self) -> torch.Tensor:
        return self.buf[3 * self.n:4 * self.n + 1]

    @property
    def seg_ids(self) -> torch.Tensor:
        return self.buf[4 * self.n + 1:5 * self.n + 1]

    @property
    def seg_first(self) -> torch.Tensor:
        return self.buf[5 * self.n + 1:6 * self.n + 1]

    @property
    def count(self) -> torch.Tensor:
        return self.buf[6 * self.n + 1:]

    def pointers(self):
        """Device addresses of order, sids, heads, seg_ids, seg_first and
        count."""
        base, n = self.buf.data_ptr(), self.n
        return (base, base + 8 * n, base + 12 * n, base + 16 * n + 4,
                base + 20 * n + 4, base + 24 * n + 4)


def _empty_grouping(n: int, device) -> Grouping:
    return Grouping(torch.empty((6 * n + 2,), dtype=torch.int32,
                                device=device), n)


def group_ids_plain(ids: torch.Tensor) -> Grouping:
    """The grouping by torch.sort(stable=True), the segments from its head
    flags (no host sync on a card)."""
    n = ids.shape[0]
    g = _empty_grouping(n, ids.device)
    g.heads.fill_(n)
    g.count.fill_(0)
    if n == 0:
        return g
    sids, order = torch.sort(ids.to(torch.int32), stable=True)
    g.sids.copy_(sids)
    g.order.copy_(order)
    head = torch.ones((n,), dtype=torch.bool, device=ids.device)
    head[1:] = sids[1:] != sids[:-1]
    seg = torch.cumsum(head, 0) - 1
    # Heads go to their segment's slot; the other positions to slot n + 1.
    slot = torch.where(head, seg, n + 1)
    pos = torch.arange(n, dtype=torch.int32, device=ids.device)
    heads = torch.full((n + 2,), n, dtype=torch.int32, device=ids.device)
    g.heads.copy_(heads.scatter_(0, slot, pos)[:n + 1])
    g.seg_ids.copy_(torch.zeros_like(heads).scatter_(0, slot, sids)[:n])
    g.seg_first.copy_(torch.zeros_like(heads).scatter_(
        0, slot, order.to(torch.int32))[:n])
    g.count.copy_(seg[-1:] + 1)
    return g


def launch_group(ids: torch.Tensor, n_rows: int, plan: GroupPlan) -> Grouping:
    """Launch the grouping on CUDA ids (checked by the caller) along
    ``plan``'s route; counts one launch of group_ids ("block") or
    group_ids_tiles ("tiles").  The tiles route takes any 1..2^31 - 1 ids
    (the kernels size themselves from n alone), its scratch from torch's
    allocator."""
    n = ids.shape[0]
    limit = GROUP_BLOCK_MAX if plan.route == "block" else _MAX_INT32
    if plan.route not in ("block", "tiles") or not 0 < n <= limit:
        raise ValueError(f"group_ids: the {plan.route} route takes "
                         f"1..{limit} ids, not {n} ({plan})")
    ids = ids.contiguous()
    g = _empty_grouping(n, ids.device)
    order, sids, heads, seg_ids, seg_first, count = g.pointers()
    lib = load_library(GROUP_SOURCE, GROUP_SIGNATURES)
    args = (ids.data_ptr(), int(ids.dtype == torch.int64), n, n_rows,
            plan.bits)
    outs = (sids, order, heads, seg_ids, seg_first, count)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        if plan.route == "block":
            err = lib.dglke_group_ids(*args, plan.items, *outs, stream)
        else:
            scratch = torch.empty((group_scratch_slots(n),),
                                  dtype=torch.int32, device=ids.device)
            err = lib.dglke_group_ids_tiles(*args, *outs, scratch.data_ptr(),
                                            scratch.numel(), stream)
    name = "group_ids" if plan.route == "block" else "group_ids_tiles"
    check_launch(err, name)
    launches[name] += 1
    return g


def group_ids(ids: torch.Tensor, n_rows: int) -> Grouping:
    """[N] int32/int64 ids in [0, n_rows) -> their Grouping.

    On the card, csrc/group_ids.cu along plan_group's route: one launch of
    one block up to GROUP_BLOCK_MAX ids, the tiles route above (counted as
    group_ids_tiles); ids out of range trap."""
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise TypeError("group_ids: ids must be a 1-D int32/int64 tensor")
    plan = plan_group(ids.shape[0], n_rows)
    if ids.device.type == "cpu" or ids.shape[0] == 0:
        return group_ids_plain(ids)
    return launch_group(ids, n_rows, plan)


# ---------------------------------------------------------------------------
# K2: segment row update (replaces rows.py:scatter_add_rows, grown into the
# whole ops/embedding.py:sparse_adagrad_update)


# Rows of up to this many elements take one warp per segment.
UPDATE_WARP_MAX = 1024


@dataclass(frozen=True)
class UpdatePlan:
    """How K2 covers a row: route "warp" (one warp per segment, holding
    ``lane_vecs`` vectors of four elements a lane) or "block" (one block
    per segment)."""
    route: str
    lane_vecs: int = 0


def plan_update(dim: int) -> UpdatePlan:
    """The K2 route for rows of ``dim`` elements: one warp up to
    UPDATE_WARP_MAX (the fewest of 1, 2, 4 or 8 vectors a lane that cover
    the row), one block above."""
    if dim <= 0:
        raise ValueError(f"plan_update: empty row ({dim})")
    if dim > UPDATE_WARP_MAX:
        return UpdatePlan("block")
    vecs = -(-dim // 128)           # four elements on each of 32 lanes
    return UpdatePlan("warp", 1 << (vecs - 1).bit_length())


def _add_rows(table: torch.Tensor, ids: torch.Tensor,
              delta: torch.Tensor) -> None:
    """table[ids] += delta per occurrence, in place.  A bf16 table's touched
    rows are summed in fp32 and rounded once, as the kernel does."""
    if table.dtype != torch.bfloat16:
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


def segment_update_mapped_plain(emb: torch.Tensor, state_sum, ids,
                                grads: torch.Tensor, lr: float) -> None:
    """A mapped table's update (K2 from the rows K1 gathered) in plain
    PyTorch, in place: each distinct id's row (and state_sum entry) copied
    out in ascending id order, the segments' order; sparse_adagrad_plain
    (or, with no state_sum, the plain row add) applied there by segment
    index; the rows written back.  The same sums in the same order as on
    the table."""
    uniq, seg = torch.unique(ids.long(), return_inverse=True)
    scratch = emb[uniq]
    if state_sum is None:
        _add_rows(scratch, seg, grads)
    else:
        scratch_ss = state_sum[uniq]
        sparse_adagrad_plain(scratch, scratch_ss, seg, grads, lr)
        state_sum[uniq] = scratch_ss
    emb[uniq] = scratch


def _check_update(emb, state_sum, ids, grads, name) -> int:
    """Argument checks of K2.  The ids and rows lie on one device; on the
    CPU so do the table and state_sum, on a card each lies there or in
    mapped host memory (checked at the launch)."""
    code = _check_table(emb, name)
    check_ids(ids, emb.device if ids.device.type == "cpu" else ids.device,
              name)
    n = ids.shape[0]
    if grads.dtype != torch.float32 or not grads.is_contiguous():
        raise TypeError(f"{name}: rows must be contiguous float32")
    if grads.shape != (n, emb.shape[1]) or grads.device != ids.device:
        raise ValueError(f"{name}: rows {tuple(grads.shape)} on "
                         f"{grads.device} do not match {n} ids on "
                         f"{ids.device} and the table {tuple(emb.shape)}")
    if state_sum is not None and (
            state_sum.dtype != torch.float32 or not state_sum.is_contiguous()
            or state_sum.shape != (emb.shape[0],)
            or state_sum.device != emb.device):
        raise ValueError(f"{name}: state_sum must be a contiguous float32 "
                         f"[{emb.shape[0]}] tensor on {emb.device}")
    return code


def _segment_update(code, emb, state_sum, ids, grads, lr, name,
                    rows=None) -> bool:
    """Group the ids, then launch the segment update along plan_update's
    route on the ids' card; False when there was nothing to launch (no
    ids).  Each segment starts from the table's row for a table on the
    card, and from ``rows`` (the table's rows at the ids, as K1 gathered
    them) for a table in mapped host memory, which then must be given:
    each touched row crosses the link once each way.  On an NVIDIA H100
    80GB HBM3 at 700 W that took 0.1395 ms for 3,000 ids x 400 fp32 where
    the row read over the link took 0.2751, and 10.30 ms for 1,000 of
    TransR's 160,000-wide rows where it took 23.36 (PERF.md, section 6)."""
    n = ids.shape[0]
    dev = ids.device
    emb_addr = _reach(emb, dev, name, "table")
    ss_addr = None if state_sum is None else _reach(state_sum, dev, name,
                                                    "state_sum")
    if emb.device == dev:
        rows = None
    elif (rows is None or rows.dtype != torch.float32
          or rows.shape != (n, emb.shape[1]) or rows.device != dev
          or not rows.is_contiguous()):
        raise ValueError(f"{name}: a mapped table needs its rows at the ids, "
                         f"contiguous fp32 [{n}, {emb.shape[1]}] on {dev}")
    if n == 0:
        return False
    if n > _MAX_INT32 or emb.shape[1] > _MAX_INT32:
        raise ValueError(f"{name}: {n} rows of {emb.shape[1]} exceed the "
                         f"kernel's 32-bit indices")
    g = group_ids(ids, emb.shape[0])
    plan = plan_update(emb.shape[1])
    order, _, heads, seg_ids, seg_first, count = g.pointers()
    lib = load_library(SOURCE, SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.dglke_segment_update(
            emb_addr, code, emb.shape[0], emb.stride(0), emb.shape[1],
            ss_addr, order, heads, seg_ids, seg_first, count,
            grads.data_ptr(), n, float(lr), int(plan.route == "block"),
            plan.lane_vecs, None if rows is None else rows.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, name)
    return True


def sparse_adagrad_rows(emb: torch.Tensor, state_sum: torch.Tensor,
                        ids: torch.Tensor, grads: torch.Tensor,
                        lr: float, rows: torch.Tensor | None = None) -> None:
    """Row-sparse Adagrad, IN PLACE on ``emb`` and ``state_sum`` (the JAX
    function returns new arrays).  emb: [E, D] fp32/bf16; state_sum: [E]
    fp32; ids: [N] with duplicates; grads: [N, D] contiguous fp32.

    Replaces dglke_tpu/ops/pallas/rows.py:scatter_add_rows, grown into the
    whole dglke_tpu/ops/embedding.py:sparse_adagrad_update.  Bound by bytes:
    the gradient rows are read once and each touched table row is read and
    written once.  On the card the ids are grouped (group_ids: one launch,
    4 + passes above GROUP_BLOCK_MAX ids), then in one launch each unique
    id's segment is summed in ascending position order and written once
    (plan_update's route), so the result does not depend on the order
    warps run in: state_sum[u] += sum
    mean(g^2); emb[u] += -lr * sum(g) / (sqrt(state_sum[u]) + 1e-10),
    rounded once to the table dtype.  A CPU table and state_sum mapped by
    map_host, with ids and rows on the card, are updated in place over the
    host link, starting from ``rows`` (the table's rows at the ids, fp32 on
    the card, as gather_rows returned them), which such a call must give.
    A table on the card or on the CPU does not read ``rows``."""
    code = _check_update(emb, state_sum, ids, grads, "sparse_adagrad_rows")
    if ids.device.type == "cpu":
        sparse_adagrad_plain(emb, state_sum, ids, grads, lr)
    elif _segment_update(code, emb, state_sum, ids, grads, lr,
                         "sparse_adagrad_rows", rows):
        launches["sparse_adagrad_rows"] += 1


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor,
                     delta: torch.Tensor,
                     rows: torch.Tensor | None = None) -> None:
    """table[ids] += delta IN PLACE with duplicates summed exactly (delta:
    [N, D] contiguous fp32) — what the TPU kernel computes, on the same
    core and routes as sparse_adagrad_rows."""
    code = _check_update(table, None, ids, delta, "scatter_add_rows")
    if ids.device.type == "cpu":
        scatter_add_plain(table, ids, delta)
    elif _segment_update(code, table, None, ids, delta, 0.0,
                         "scatter_add_rows", rows):
        launches["scatter_add_rows"] += 1
