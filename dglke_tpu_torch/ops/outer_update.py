"""RESCAL's relation Adagrad with a rank-1 gradient per edge: a CUDA kernel
and its plain PyTorch version (counterpart of
dglke_tpu/ops/pallas/outer_update.py).

RESCAL's per-edge relation gradient is rank 1 (``ops/csrc/outer_update.cu``
says why and how the kernel uses it).  The update, IN PLACE on the table:

    g_i   = a_i (x) b_i + reg'(R[ids[i]])            # [Da*Db] per occurrence
    ss[u] += mean(g_i^2)                             # all adds first
    R[u]  -= lr * g_i / (sqrt(ss[u]) + 1e-10)        # per occurrence

with reg'(x) = coef * p * |x|^(p-1) * sign(x) taken from the row's value
before the update: exactly ``sparse_adagrad_update`` on the materialized
gradient, which the kernel never forms.  The kernel is built and counted
through ``ops/rows.py``.

On the card the row width picks one of two routes (``plan_outer``): a
thread-block cluster that holds each touched row in shared memory and
reads and writes it once, or, for rows wider than a cluster holds, three
launches over 2,048-element tiles that read each row twice.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from dglke_tpu_torch.ops import rows
from dglke_tpu_torch.ops.embedding import EmbeddingState

SOURCE = rows.CSRC / "outer_update.cu"
_P, _I64, _INT, _F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_float)
SIGNATURES = {
    "dglke_outer_adagrad": ([_P, _I64, _I64, _P, _P, _P, _P, _P, _I64, _INT,
                             _INT, _F, _F, _INT, _P, _P, _P], _INT),
    "dglke_outer_adagrad_cluster": ([_P, _I64, _I64, _P, _P, _P, _P, _P, _I64,
                                     _INT, _INT, _F, _F, _INT, _INT, _INT,
                                     _INT, _INT, _P, _P], _INT),
    "dglke_outer_cluster_occupancy": ([_INT, _I64,
                                       ctypes.POINTER(ctypes.c_int)], _INT),
}
_TILE = 2048              # row elements per block (kTile in the source)
_MAX_WIDTH = 1 << 30      # the kernel indexes a row with 32-bit ints

# The cluster route (sizes in bytes of fp32 row elements per CTA):
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is non-portable, allowed explicitly
SLICE_TARGET = 100 * 1024   # at most this, two CTAs share an SM
SLICE_MAX = 200 * 1024      # above this at 16 CTAs: the tiles route
SMEM_MAX = 225 * 1024       # of a block's 227 KB; the rest is static
STAGE_BYTES = 32 * 1024     # factors staged beside the slice
STAGE_OCC_MAX = 32          # occurrences staged at most


@dataclass(frozen=True)
class OuterPlan:
    """How the kernel covers a row of da * db elements.

    route: "cluster" or "tiles".  On the cluster route: ``cluster`` CTAs,
    each over ``slice`` elements (a multiple of 4, so slices start 16-byte
    aligned); room for the ``span`` rows of ``a`` under one slice; segments
    of at most ``stage_occ`` occurrences have their factors staged in
    shared memory; ``smem_bytes`` of dynamic shared memory per CTA."""
    route: str
    cluster: int = 0
    slice: int = 0
    span: int = 0
    stage_occ: int = 0
    smem_bytes: int = 0


def _cluster_plan(da: int, db: int, cluster: int) -> OuterPlan:
    sl = -(-da * db // cluster)
    sl += -sl % 4
    span = min(da, (sl - 1) // db + 2)
    stage = max(0, min(STAGE_BYTES, SMEM_MAX - 4 * sl))
    occ = min(STAGE_OCC_MAX, stage // (4 * (span + db)))
    return OuterPlan("cluster", cluster, sl, span, occ,
                     4 * (sl + occ * (span + db)))


def plan_outer(da: int, db: int, cluster: int | None = None) -> OuterPlan:
    """The route for rows of da * db fp32 elements: the smallest cluster
    whose slices are at most SLICE_TARGET bytes, else 16 CTAs with slices
    up to SLICE_MAX, else the tiles route.  ``cluster`` forces a cluster
    size (to time one against another); it raises if that size cannot hold
    the row."""
    if da <= 0 or db <= 0:
        raise ValueError(f"plan_outer: empty row ({da} x {db})")
    if cluster is not None:
        plan = _cluster_plan(da, db, cluster)
        if cluster not in CLUSTER_SIZES or 4 * plan.slice > SLICE_MAX:
            raise ValueError(f"plan_outer: {cluster} CTAs cannot hold a row "
                             f"of {da * db} fp32 elements")
        return plan
    for c in CLUSTER_SIZES:
        plan = _cluster_plan(da, db, c)
        if 4 * plan.slice <= SLICE_TARGET:
            return plan
    return plan if 4 * plan.slice <= SLICE_MAX else OuterPlan("tiles")


def reg_grad(x: torch.Tensor, coef: float, norm: int) -> torch.Tensor:
    """d/dx of coef * sum|x|^p (models/loss.py:regularization), for
    coef != 0 and p > 0."""
    return coef * norm * torch.abs(x) ** (norm - 1) * torch.sign(x)


def outer_adagrad_plain(emb: torch.Tensor, state_sum: torch.Tensor,
                        ids: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        lr: float, reg_coef: float = 0.0,
                        reg_norm: int = 0) -> None:
    """The update on the materialized [N, Da*Db] gradient, in place."""
    ids = ids.long()
    g = torch.einsum("bi,bj->bij", a, b).reshape(ids.shape[0], -1)
    if reg_coef != 0.0 and reg_norm > 0:
        g = g + reg_grad(emb[ids], reg_coef, reg_norm)
    rows.sparse_adagrad_plain(emb, state_sum, ids, g, lr)


def _check(table: EmbeddingState, ids, a, b) -> None:
    emb, ss = table.emb, table.state_sum
    if emb.dtype != torch.float32:
        raise TypeError("outer_adagrad_update: the table must be float32 "
                        f"(got {emb.dtype})")
    if emb.dim() != 2 or emb.stride(1) != 1:
        raise ValueError("outer_adagrad_update: table must be 2-D with unit "
                         "column stride")
    rows.check_ids(ids, emb.device, "outer_adagrad_update")
    n = ids.shape[0]
    for name, f in (("a", a), ("b", b)):
        if f.dtype != torch.float32 or f.dim() != 2 or f.shape[0] != n \
                or f.device != emb.device:
            raise ValueError(f"outer_adagrad_update: {name} must be a float32 "
                             f"[{n}, D] tensor on {emb.device}, got "
                             f"{f.dtype} {tuple(f.shape)} on {f.device}")
    if a.shape[1] * b.shape[1] != emb.shape[1]:
        raise ValueError(f"outer_adagrad_update: {a.shape[1]} x "
                         f"{b.shape[1]} factors do not make the table's "
                         f"row width {emb.shape[1]}")
    if emb.shape[1] > _MAX_WIDTH:
        raise ValueError(f"outer_adagrad_update: row width {emb.shape[1]} "
                         f"above {_MAX_WIDTH}")
    if (ss.dtype != torch.float32 or not ss.is_contiguous()
            or ss.shape != (emb.shape[0],) or ss.device != emb.device):
        raise ValueError("outer_adagrad_update: state_sum must be a "
                         f"contiguous float32 [{emb.shape[0]}] tensor on "
                         f"{emb.device}")


def cluster_occupancy(plan: OuterPlan) -> int:
    """cudaOccupancyMaxActiveClusters for a cluster-route plan (on the
    current card)."""
    if plan.route != "cluster":
        raise ValueError("cluster_occupancy: not a cluster-route plan")
    lib = rows.load_library(SOURCE, SIGNATURES)
    out = ctypes.c_int(0)
    rows.check_launch(lib.dglke_outer_cluster_occupancy(
        plan.cluster, plan.smem_bytes, ctypes.byref(out)),
        "cluster_occupancy")
    return out.value


def launch_outer(table: EmbeddingState, ids: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, lr: float, reg_coef: float, reg_norm: int,
                 plan: OuterPlan) -> None:
    """Launch the kernel on CUDA tensors along ``plan``'s route (checked by
    the caller); counts one launch of outer_adagrad_update."""
    emb, state_sum = table.emb, table.state_sum
    n = ids.shape[0]
    if n == 0:
        return
    a, b = a.contiguous(), b.contiguous()
    # Preprocessing, not the update: the stable sort groups equal ids into
    # segments (the JAX wrapper's argsort).
    sids, order = torch.sort(ids.to(torch.int32), stable=True)
    reg_pow = int(reg_norm) if reg_coef != 0.0 and reg_norm > 0 else 0
    common = (emb.data_ptr(), emb.shape[0], emb.stride(0),
              state_sum.data_ptr(), sids.data_ptr(), order.data_ptr(),
              a.data_ptr(), b.data_ptr(), n, a.shape[1], b.shape[1],
              float(lr), float(reg_coef * reg_norm), reg_pow)
    lib = rows.load_library(SOURCE, SIGNATURES)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        if plan.route == "cluster":
            heads = torch.empty((n + 2,), dtype=torch.int64,
                                device=emb.device)
            err = lib.dglke_outer_adagrad_cluster(
                *common, plan.cluster, plan.slice, plan.span, plan.stage_occ,
                heads.data_ptr(), stream)
        else:
            tiles = -(-emb.shape[1] // _TILE)
            partial = torch.empty((n * tiles,), dtype=torch.float32,
                                  device=emb.device)
            std = torch.empty((n,), dtype=torch.float32, device=emb.device)
            err = lib.dglke_outer_adagrad(*common, partial.data_ptr(),
                                          std.data_ptr(), stream)
    rows.check_launch(err, "outer_adagrad_update")
    rows.launches["outer_adagrad_update"] += 1


def outer_adagrad_update(table: EmbeddingState, ids: torch.Tensor,
                         a: torch.Tensor, b: torch.Tensor, lr: float,
                         reg_coef: float = 0.0,
                         reg_norm: int = 0) -> EmbeddingState:
    """Row-sparse Adagrad with grad[i] = a[i] (x) b[i] + reg'(row), IN PLACE
    on ``table`` (returned for convenience; the JAX function returns a new
    state).  table.emb: [E, Da*Db] float32 only; ids: [N] (duplicates
    allowed); a: [N, Da]; b: [N, Db] float32.

    Replaces dglke_tpu/ops/pallas/outer_update.py:outer_adagrad_update.
    Bound by bytes: each distinct row read and written once.  On the card
    the ids are sorted (stable) and each segment of equal ids is summed in
    a fixed order, so two runs give the same bits; the route follows from
    the width (plan_outer)."""
    _check(table, ids, a, b)
    if table.emb.device.type == "cpu":
        outer_adagrad_plain(table.emb, table.state_sum, ids, a, b, lr,
                            reg_coef, reg_norm)
        return table
    launch_outer(table, ids, a, b, lr, reg_coef, reg_norm,
                 plan_outer(a.shape[1], b.shape[1]))
    return table
