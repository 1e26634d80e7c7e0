"""TransE with the L2 distance, in plain PyTorch: score = gamma - ||h + r -
t||.  A chunk's negatives are scored through
dgl-ke's expansion ||a||^2 + ||b||^2 - 2 a.b (clamped at 1e-30 before the
square root), so that a matrix product does the O(D) work; positives
take the direct difference."""

from __future__ import annotations

import torch


def tables(hidden: int, emb_init: float) -> list:
    """[(width, init range)] of the entity and the relation table."""
    return [(hidden, emb_init), (hidden, emb_init)]


def _dist(a, b):
    sq = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
          - 2.0 * torch.matmul(a, b.transpose(-1, -2)))
    return torch.sqrt(torch.clamp(sq, min=1e-30))


def pos_score(h, r, t, flags):
    return flags["gamma"] - torch.sqrt(((h + r - t) ** 2).sum(-1) + 1e-30)


def _query(side, r, neg_head):
    # head-corrupt: ||n + r - t|| = ||(t - r) - n||
    return side - r if neg_head else side + r


def neg_scores(side, r, neg, neg_head: bool, chunks: int, flags):
    """[B, K] scores of each positive's chunk of K shared negatives;
    ``side`` is the kept side's rows [B, D], ``neg`` [chunks * K, D]."""
    b, d = side.shape
    q = _query(side, r, neg_head).reshape(chunks, b // chunks, d)
    n = neg.reshape(chunks, -1, d)
    return (flags["gamma"] - _dist(q, n)).reshape(b, -1)
