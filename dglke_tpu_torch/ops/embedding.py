"""Embedding tables and row-sparse Adagrad (counterpart of
dglke_tpu/ops/embedding.py).

The update follows the reference's ``ExternalEmbedding.update``:

    state_sum[ids] += mean(grad**2, dim=1)          # per occurrence
    std = sqrt(state_sum[ids]) + 1e-10              # read AFTER all adds
    emb[ids]       += -lr * grad / std              # per occurrence

Because ``std`` is read after the full accumulation, duplicate ids are
equivalent to a deduplicated update with segment-summed gradients, which is
what the CUDA kernel computes (ops/rows.py).  Tables store their logical
width; optimizer math and ``state_sum`` are float32 whatever the table
dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from dglke_tpu_torch.ops import rows


class EmbeddingState(nn.Module):
    """One embedding table plus its Adagrad row accumulator."""

    def __init__(self, emb: torch.Tensor, state_sum: torch.Tensor):
        super().__init__()
        self.register_buffer("emb", emb)               # [num, dim]
        self.register_buffer("state_sum", state_sum)   # [num] fp32


def init_embedding(generator: torch.Generator, num: int, dim: int,
                   emb_init: float, dtype=torch.float32,
                   device="cuda") -> EmbeddingState:
    """Uniform(-emb_init, emb_init) init drawn from ``generator`` (which
    must live on ``device``), zero Adagrad state.  The accumulator stays
    fp32 for bf16 tables: its monotone sum of squares underflows in bf16."""
    emb = torch.empty((num, dim), dtype=torch.float32, device=device)
    emb.uniform_(-emb_init, emb_init, generator=generator)
    return EmbeddingState(emb.to(dtype),
                          torch.zeros((num,), dtype=torch.float32,
                                      device=device))


def segment_dedup(ids: torch.Tensor, grads: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-shape dedup: sum the gradient rows of duplicate ids.

    Not on the training path: kept as the documented equivalence baseline
    of sparse_adagrad_update.  Returns (uniq_ids [N], uniq_grads [N, D],
    uniq_sq [N]); only the first n_unique slots are populated, the rest
    hold id 0 with zero grads (no-op rows for an add).  uniq_sq is the
    segment sum of mean(grad**2, dim=1)."""
    n = ids.shape[0]
    sids, order = torch.sort(ids.long(), stable=True)
    sgrads = grads[order]
    head = torch.ones_like(sids)
    head[1:] = (sids[1:] != sids[:-1]).long()
    seg = torch.cumsum(head, 0) - 1
    uniq_grads = torch.zeros_like(grads).index_add_(0, seg, sgrads)
    sq = torch.mean(sgrads * sgrads, dim=1)
    uniq_sq = torch.zeros((n,), dtype=grads.dtype,
                          device=grads.device).index_add_(0, seg, sq)
    uniq_ids = torch.zeros((n,), dtype=ids.dtype, device=ids.device)
    uniq_ids[seg] = sids.to(ids.dtype)
    return uniq_ids, uniq_grads, uniq_sq


def sparse_adagrad_update(table: EmbeddingState, ids: torch.Tensor,
                          grads: torch.Tensor, lr: float,
                          gathered=None) -> EmbeddingState:
    """The reference's row-sparse Adagrad for one (ids, grads) batch, IN
    PLACE on ``table`` (returned for convenience; the JAX function returns
    a new state).  ids: [N] (duplicates allowed); grads: [N, D] fp32.
    ``gathered``: the table's rows at ids as gather_rows returned them in
    the same step, which K2 reads in place of a mapped table's and a mapped
    table needs (rows.sparse_adagrad_rows)."""
    grads = grads.to(torch.float32).contiguous()
    if gathered is None:
        rows.sparse_adagrad_rows(table.emb, table.state_sum, ids, grads, lr)
    else:
        rows.sparse_adagrad_rows(table.emb, table.state_sum, ids, grads, lr,
                                 rows=gathered)
    return table


def gather_rows(table: EmbeddingState, ids: torch.Tensor,
                dim: int | None = None) -> torch.Tensor:
    """Minibatch gather (the reference's ExternalEmbedding.__call__): fp32
    rows of the first ``dim`` columns."""
    return rows.gather_rows(table.emb, ids, dim)


def gather_rows_matvec(table: EmbeddingState, ids: torch.Tensor,
                       vecs: torch.Tensor, head: bool, p: int,
                       dim: int | None = None):
    """RESCAL's relation gather: the rows, their sum of |x|^p (None for p =
    0) and each row's [hidden, hidden] matrix times its vector of ``vecs``
    (rows.gather_rows_matvec: formed by K1 as it copies wide fp32 rows on
    the card, by PyTorch on every other route)."""
    return rows.gather_rows_matvec(table.emb, ids, vecs, head, p, dim)
