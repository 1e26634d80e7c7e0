"""Score functions (counterpart of dglke_tpu/models/score_functions.py).

Each family has two forms:

  * ``pos_score(h, r, t) -> [B]``: per-edge positive score.
  * ``neg_score(emb, rel, neg_emb, neg_head, C, Bc, K) -> [C, Bc, K]``:
    chunked negative scoring, each chunk of Bc positives against K shared
    corrupted heads/tails.  The translational family uses the
    |a|^2+|b|^2-2ab expansion so the O(Bc*K*D) work is one batched matmul.

All eight families are ported: TransE (l1, l2), TransR, DistMult,
ComplEx, RESCAL, RotatE and SimplE, with the JAX package's two deliberate
deviations from dgl-ke (the TransR tail-corrupt sign and the RESCAL
tail-negative transpose).  The ``infer_score`` forms of the predict tools
are not ported yet.  Scoring is full fp32: the caller keeps TF32 off.
"""

from __future__ import annotations

import dataclasses
import math

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


def _split(x: torch.Tensor):
    h = x.shape[-1] // 2
    return x[..., :h], x[..., h:]


def _chunk_dot(tmp, neg_emb, num_chunks, chunk_size, neg_sample_size):
    """[C, Bc, K] dot products of each chunk's [Bc, D] rows with its [K, D]
    negatives."""
    d = tmp.shape[-1]
    tmp = tmp.reshape(num_chunks, chunk_size, d)
    neg = neg_emb.reshape(num_chunks, neg_sample_size, d)
    return torch.matmul(tmp, neg.transpose(1, 2))


@dataclasses.dataclass(frozen=True)
class TransRScore:
    """gamma - L1 after projecting the entities into relation space by a
    per-relation [De, Dr] matrix (the rows of a third table).  ``project``
    maps each edge's entities by its own relation; ``neg_project`` maps
    every negative by every relation of its chunk."""

    gamma: float
    entity_dim: int
    relation_dim: int
    name = "TransR"

    def project(self, ent, proj):
        """ent: [B, De], proj: [B, De*Dr] -> [B, Dr]."""
        p = proj.reshape(-1, self.entity_dim, self.relation_dim)
        return torch.sum(ent[:, :, None] * p, dim=1)

    def neg_project(self, neg_ent, proj, num_chunks):
        """neg_ent: [C*K, De], proj: [B, De*Dr] -> [C, Bc, K, Dr]."""
        p = proj.reshape(num_chunks, -1, self.entity_dim, self.relation_dim)
        n = neg_ent.reshape(num_chunks, -1, self.entity_dim)
        return torch.einsum("ckd,cbdr->cbkr", n, p)

    def pos_score(self, head, rel, tail):
        # head/tail already projected to [B, Dr]
        return self.gamma - _norm(head + rel - tail, 1)

    def neg_score(self, emb, rel, neg_emb, *, neg_head, num_chunks,
                  chunk_size, neg_sample_size):
        """emb: [C, Bc, Dr] projected positive-side rows; neg_emb:
        [C, Bc, K, Dr] projected negatives (from neg_project)."""
        rel = rel.reshape(num_chunks, chunk_size, self.relation_dim)
        if neg_head:
            diff = neg_emb - (emb - rel)[:, :, None, :]
        else:
            # h + r, as in the positive score (the JAX package's fix of
            # dgl-ke's |h - r - t'|)
            diff = (emb + rel)[:, :, None, :] - neg_emb
        return self.gamma - torch.sum(torch.abs(diff), dim=-1)


@dataclasses.dataclass(frozen=True)
class DistMultScore:
    name = "DistMult"

    def pos_score(self, head, rel, tail):
        return torch.sum(head * rel * tail, dim=-1)

    def neg_score(self, emb, rel, neg_emb, *, neg_head, num_chunks,
                  chunk_size, neg_sample_size):
        return _chunk_dot(emb * rel, neg_emb, num_chunks, chunk_size,
                          neg_sample_size)


@dataclasses.dataclass(frozen=True)
class ComplExScore:
    name = "ComplEx"

    def pos_score(self, head, rel, tail):
        re_h, im_h = _split(head)
        re_t, im_t = _split(tail)
        re_r, im_r = _split(rel)
        s = (re_h * re_t * re_r + im_h * im_t * re_r
             + re_h * im_t * im_r - im_h * re_t * im_r)
        return torch.sum(s, dim=-1)

    def neg_score(self, emb, rel, neg_emb, *, neg_head, num_chunks,
                  chunk_size, neg_sample_size):
        re_e, im_e = _split(emb)
        re_r, im_r = _split(rel)
        if neg_head:
            # tail rows times the conjugate relation
            real = re_e * re_r + im_e * im_r
            imag = -re_e * im_r + im_e * re_r
        else:
            real = re_e * re_r - im_e * im_r
            imag = re_e * im_r + im_e * re_r
        return _chunk_dot(torch.cat([real, imag], dim=-1), neg_emb,
                          num_chunks, chunk_size, neg_sample_size)


@dataclasses.dataclass(frozen=True)
class RESCALScore:
    """h . (R t), R stored flat [Dr*De] per relation and viewed as
    [Dr, De]."""

    relation_dim: int
    entity_dim: int
    name = "RESCAL"

    def _mat(self, rel):
        return rel.reshape(rel.shape[:-1] + (self.relation_dim,
                                             self.entity_dim))

    def pos_score(self, head, rel, tail):
        rt = torch.matmul(self._mat(rel), tail[..., None])[..., 0]
        return torch.sum(head * rt, dim=-1)

    def neg_score(self, emb, rel, neg_emb, *, neg_head, num_chunks,
                  chunk_size, neg_sample_size):
        rmat = self._mat(rel)
        if neg_head:
            tmp = torch.matmul(rmat, emb[:, :, None])[:, :, 0]     # R t
        else:
            # h^T R, so that neg and pos scores agree (the JAX package's fix
            # of dgl-ke's (R h) . t')
            tmp = torch.matmul(emb[:, None, :], rmat)[:, 0, :]
        return _chunk_dot(tmp, neg_emb, num_chunks, chunk_size,
                          neg_sample_size)


@dataclasses.dataclass(frozen=True)
class RotatEScore:
    gamma: float
    emb_init: float
    name = "RotatE"

    def _rotation(self, rel):
        phase = rel / (self.emb_init / math.pi)
        return torch.cos(phase), torch.sin(phase)

    def pos_score(self, head, rel, tail):
        re_h, im_h = _split(head)
        re_t, im_t = _split(tail)
        re_r, im_r = self._rotation(rel)
        re_s = re_h * re_r - im_h * im_r - re_t
        im_s = re_h * im_r + im_h * re_r - im_t
        # +eps: NaN-gradient guard at zero modulus (see _norm)
        dist = torch.sqrt(re_s * re_s + im_s * im_s + 1e-30)
        return self.gamma - torch.sum(dist, dim=-1)

    def neg_score(self, emb, rel, neg_emb, *, neg_head, num_chunks,
                  chunk_size, neg_sample_size):
        # real and imaginary planes stay separate through the [C, Bc, K,
        # D/2] broadcast: only [B, D]-sized tensors are split
        h = emb.shape[-1] // 2
        re_e, im_e = _split(emb)
        re_r, im_r = self._rotation(rel)
        if neg_head:
            real = re_e * re_r + im_e * im_r
            imag = -re_e * im_r + im_e * re_r
        else:
            real = re_e * re_r - im_e * im_r
            imag = re_e * im_r + im_e * re_r
        real = real.reshape(num_chunks, chunk_size, 1, h)
        imag = imag.reshape(num_chunks, chunk_size, 1, h)
        re_n = neg_emb[..., :h].reshape(num_chunks, 1, neg_sample_size, h)
        im_n = neg_emb[..., h:].reshape(num_chunks, 1, neg_sample_size, h)
        re_d = real - re_n
        im_d = imag - im_n
        dist = torch.sqrt(re_d * re_d + im_d * im_d + 1e-30)
        return self.gamma - torch.sum(dist, dim=-1)


@dataclasses.dataclass(frozen=True)
class SimplEScore:
    name = "SimplE"

    def pos_score(self, head, rel, tail):
        h_i, h_j = _split(head)
        t_i, t_j = _split(tail)
        r, r_inv = _split(rel)
        s = torch.sum(h_i * r * t_j + t_i * r_inv * h_j, dim=-1)
        return torch.clamp(0.5 * s, -20.0, 20.0)

    def neg_score(self, emb, rel, neg_emb, *, neg_head, num_chunks,
                  chunk_size, neg_sample_size):
        e_i, e_j = _split(emb)
        r, r_inv = _split(rel)
        n_i, n_j = _split(neg_emb)
        if neg_head:
            fwd, bwd, n_fwd, n_bwd = r * e_j, r_inv * e_i, n_i, n_j
        else:
            fwd, bwd, n_fwd, n_bwd = e_i * r, r_inv * e_j, n_j, n_i
        args = (num_chunks, chunk_size, neg_sample_size)
        s = _chunk_dot(fwd, n_fwd, *args) + _chunk_dot(bwd, n_bwd, *args)
        return torch.clamp(0.5 * s, -20.0, 20.0)


def make_score_function(model_name: str, gamma: float, hidden_dim: int,
                        double_ent: bool = False, double_rel: bool = False):
    """The score function plus (entity_dim, relation_dim).  RESCAL's
    relation rows are flattened [Dr, De] matrices; RotatE's emb_init uses
    the un-doubled hidden dim."""
    entity_dim = 2 * hidden_dim if double_ent else hidden_dim
    relation_dim = 2 * hidden_dim if double_rel else hidden_dim
    emb_init = (gamma + 2.0) / hidden_dim
    if model_name in ("TransE", "TransE_l2"):
        return TransEScore(gamma, 2), entity_dim, relation_dim
    if model_name == "TransE_l1":
        return TransEScore(gamma, 1), entity_dim, relation_dim
    if model_name == "TransR":
        return (TransRScore(gamma, entity_dim, relation_dim), entity_dim,
                relation_dim)
    if model_name == "DistMult":
        return DistMultScore(), entity_dim, relation_dim
    if model_name == "ComplEx":
        return ComplExScore(), entity_dim, relation_dim
    if model_name == "RESCAL":
        return (RESCALScore(relation_dim, entity_dim), entity_dim,
                relation_dim * entity_dim)
    if model_name == "RotatE":
        return RotatEScore(gamma, emb_init), entity_dim, relation_dim
    if model_name == "SimplE":
        return SimplEScore(), entity_dim, relation_dim
    raise ValueError(f"unknown model {model_name}")
