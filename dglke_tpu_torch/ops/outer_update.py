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
"""

from __future__ import annotations

import ctypes

import torch

from dglke_tpu_torch.ops import rows
from dglke_tpu_torch.ops.embedding import EmbeddingState

SOURCE = rows.CSRC / "outer_update.cu"
_P, _I64, _INT, _F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_float)
SIGNATURES = {
    "dglke_outer_adagrad": ([_P, _I64, _I64, _P, _P, _P, _P, _P, _I64, _INT,
                             _INT, _F, _F, _INT, _P, _P, _P], _INT),
}
_TILE = 2048              # row elements per block (kTile in the source)
_MAX_WIDTH = 1 << 30      # the kernel indexes a row with 32-bit ints


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
    a fixed order, so two runs give the same bits."""
    _check(table, ids, a, b)
    emb, state_sum = table.emb, table.state_sum
    if emb.device.type == "cpu":
        outer_adagrad_plain(emb, state_sum, ids, a, b, lr, reg_coef, reg_norm)
        return table
    n = ids.shape[0]
    if n == 0:
        return table
    a, b = a.contiguous(), b.contiguous()
    # Preprocessing, not the update: the stable sort groups equal ids into
    # segments (the JAX wrapper's argsort).
    sids, order = torch.sort(ids.to(torch.int32), stable=True)
    tiles = -(-emb.shape[1] // _TILE)
    partial = torch.empty((n * tiles,), dtype=torch.float32,
                          device=emb.device)
    std = torch.empty((n,), dtype=torch.float32, device=emb.device)
    reg_pow = int(reg_norm) if reg_coef != 0.0 and reg_norm > 0 else 0
    lib = rows.load_library(SOURCE, SIGNATURES)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = lib.dglke_outer_adagrad(
            emb.data_ptr(), emb.shape[0], emb.stride(0),
            state_sum.data_ptr(), sids.data_ptr(), order.data_ptr(),
            a.data_ptr(), b.data_ptr(), n, a.shape[1], b.shape[1],
            float(lr), float(reg_coef * reg_norm), reg_pow,
            partial.data_ptr(), std.data_ptr(), stream)
    rows.check_launch(err, "outer_adagrad_update")
    rows.launches["outer_adagrad_update"] += 1
    return table
