"""Score functions (counterpart of dglke_tpu/models/score_functions.py).

Each family has two forms:

  * ``pos_score(h, r, t) -> [B]``: per-edge positive score.
  * ``neg_score(emb, rel, neg_emb, neg_head, C, Bc, K) -> [C, Bc, K]``:
    chunked negative scoring, each chunk of Bc positives against K shared
    corrupted heads/tails.  The translational family uses the
    |a|^2+|b|^2-2ab expansion so the O(Bc*K*D) work is one batched matmul.

Only TransE (l1 and l2) is ported so far; make_score_function refuses the
other families.  Scoring is full fp32: the caller keeps TF32 off.
"""

from __future__ import annotations

import dataclasses

import torch


def batched_l2_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a_i - b_j||_2 for batched a:[...,M,D], b:[...,N,D] -> [...,M,N],
    through the matmul expansion; clamped at 1e-30 before the sqrt to avoid
    NaN gradients at zero distance."""
    a_sq = torch.sum(a * a, dim=-1)
    b_sq = torch.sum(b * b, dim=-1)
    ab = torch.matmul(a, b.transpose(-1, -2))
    sq = a_sq[..., :, None] + b_sq[..., None, :] - 2.0 * ab
    return torch.sqrt(torch.clamp(sq, min=1e-30))


def batched_l1_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a_i - b_j||_1 for batched a:[...,M,D], b:[...,N,D] -> [...,M,N];
    materializes the [..., M, N, D] broadcast."""
    return torch.sum(torch.abs(a[..., :, None, :] - b[..., None, :, :]),
                     dim=-1)


def _norm(x: torch.Tensor, ord: int, dim: int = -1) -> torch.Tensor:
    if ord == 1:
        return torch.sum(torch.abs(x), dim=dim)
    # +1e-30 inside the sqrt: a zero distance keeps a finite gradient
    # (0 after the chain rule) instead of NaN-poisoning the tables.
    return torch.sqrt(torch.sum(x * x, dim=dim) + 1e-30)


@dataclasses.dataclass(frozen=True)
class TransEScore:
    gamma: float
    dist_ord: int = 2  # 1 or 2

    @property
    def name(self) -> str:
        return "TransE_l1" if self.dist_ord == 1 else "TransE_l2"

    def pos_score(self, head, rel, tail):
        return self.gamma - _norm(head + rel - tail, self.dist_ord)

    def neg_score(self, emb, rel, neg_emb, *, neg_head, num_chunks,
                  chunk_size, neg_sample_size):
        d = emb.shape[-1]
        if neg_head:
            pos = (emb - rel).reshape(num_chunks, chunk_size, d)
        else:
            pos = (emb + rel).reshape(num_chunks, chunk_size, d)
        neg = neg_emb.reshape(num_chunks, neg_sample_size, d)
        dist = batched_l2_dist if self.dist_ord == 2 else batched_l1_dist
        return self.gamma - dist(pos, neg)


def make_score_function(model_name: str, gamma: float, hidden_dim: int,
                        double_ent: bool = False, double_rel: bool = False):
    """The score function plus (entity_dim, relation_dim)."""
    entity_dim = 2 * hidden_dim if double_ent else hidden_dim
    relation_dim = 2 * hidden_dim if double_rel else hidden_dim
    if model_name in ("TransE", "TransE_l2"):
        return TransEScore(gamma, 2), entity_dim, relation_dim
    if model_name == "TransE_l1":
        return TransEScore(gamma, 1), entity_dim, relation_dim
    raise NotImplementedError(
        f"dglke_tpu_torch does not port {model_name} yet: the other score "
        "families are ROADMAP item A7")
