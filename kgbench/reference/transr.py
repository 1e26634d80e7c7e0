"""TransR in plain PyTorch, from dgl-ke's definition: score = gamma -
||h M_r + r - t M_r||_1, M_r each relation's row of the projection table
viewed as a [entity dim, relation dim] matrix.  A chunk's shared
negatives are each projected by the matrix of every triple of the chunk.

The projection is a third table keyed by relation, drawn after the
relation table with the range 1.0 (dgl-ke's ``projection_emb.init(1.0)``)
and updated by the same row-sparse Adagrad; dgl-ke regularizes the entity
and relation rows only, and so does ``train_steps``.

Where this departs from dgl-ke:
- tail-corrupt negatives n score |h M_r + r - n M_r|, as the positives
  and the port do; dgl-ke's tail-corrupt function takes h M_r - r;
- each negative's projection is one batched product over the chunk, where
  dgl-ke loops over the chunk's negatives; the same sums;
- |x| has the gradient 0 at x = 0 (torch.abs); the port's takes +1 there.
  An L1 component of exactly 0 is a measure-zero event in fp32."""

from __future__ import annotations

import torch


def tables(hidden: int, emb_init: float) -> list:
    """Entity, relation and projection tables: [(width, init range)]."""
    return [(hidden, emb_init), (hidden, emb_init), (hidden * hidden, 1.0)]


def _project(x, proj):
    """x [B, De] by each row's own matrix, proj [B, De * Dr] -> [B, Dr]."""
    m = proj.reshape(x.shape[0], x.shape[1], -1)
    return torch.bmm(x[:, None, :], m)[:, 0, :]


def pos_score(h, r, t, flags, proj):
    return flags["gamma"] - torch.abs(
        _project(h, proj) + r - _project(t, proj)).sum(-1)


def neg_scores(side, r, neg, neg_head: bool, chunks: int, flags, proj):
    """[B, K] scores of each positive's chunk of K shared negatives,
    every negative projected by the positive's own relation."""
    b, de = side.shape
    bc = b // chunks
    m = proj.reshape(chunks, bc, de, -1)                   # [C, Bc, De, Dr]
    n = neg.reshape(chunks, 1, -1, de)                     # [C, 1, K, De]
    n_proj = torch.matmul(n, m)                            # [C, Bc, K, Dr]
    kept = _project(side, proj).reshape(chunks, bc, 1, -1)
    rel = r.reshape(chunks, bc, 1, -1)
    if neg_head:                                           # |n M + r - t M|
        diff = n_proj + rel - kept
    else:                                                  # |h M + r - n M|
        diff = kept + rel - n_proj
    return (flags["gamma"] - torch.abs(diff).sum(-1)).reshape(b, -1)
