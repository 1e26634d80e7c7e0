"""RESCAL in plain PyTorch: score = h . (R t), R each relation's row viewed
as a [hidden, hidden] matrix.  Head-corrupt negatives n score n . (R t),
tail-corrupt ones (h^T R) . n (the port's orientation: positives and
negatives agree)."""

from __future__ import annotations

import torch


def tables(hidden: int, emb_init: float) -> list:
    return [(hidden, emb_init), (hidden * hidden, emb_init)]


def _mat(r, d):
    return r.reshape(r.shape[0], d, d)


def pos_score(h, r, t, flags):
    rt = torch.bmm(_mat(r, h.shape[1]), t[:, :, None])[:, :, 0]
    return (h * rt).sum(-1)


def _tmp(side, r, neg_head):
    m = _mat(r, side.shape[1])
    if neg_head:                                   # R t
        return torch.bmm(m, side[:, :, None])[:, :, 0]
    return torch.bmm(side[:, None, :], m)[:, 0, :]  # h^T R


def neg_scores(side, r, neg, neg_head: bool, chunks: int, flags):
    b, d = side.shape
    tmp = _tmp(side, r, neg_head).reshape(chunks, b // chunks, d)
    n = neg.reshape(chunks, -1, d)
    return torch.matmul(tmp, n.transpose(1, 2)).reshape(b, -1)
