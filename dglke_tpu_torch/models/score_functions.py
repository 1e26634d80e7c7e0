"""Score functions (counterpart of dglke_tpu/models/score_functions.py).

Each family has three forms:

  * ``pos_score(h, r, t) -> [B]``: per-edge positive score.
  * ``neg_score(emb, rel, neg_emb, neg_head, C, Bc, K) -> [C, Bc, K]``:
    chunked negative scoring, each chunk of Bc positives against K shared
    corrupted heads/tails.  The translational family uses the
    |a|^2+|b|^2-2ab expansion so the O(Bc*K*D) work is one batched matmul.
  * ``infer_score(h, r, t) -> [H, R, T]``: every (head, relation, tail)
    combination, for the predict tools.  Where the JAX package leaves XLA
    to fuse an [H, R, T, D] broadcast, the port computes distances with
    ``torch.cdist`` (direct differences, not the expansion, so near ties
    round as the broadcast does) or blocks under INFER_BUDGET elements;
    TransR's all-pairs form is ``transr_allpairs_score``.

All eight families are ported: TransE (l1, l2), TransR, DistMult,
ComplEx, RESCAL, RotatE and SimplE, with the JAX package's two deliberate
deviations from dgl-ke (the TransR tail-corrupt sign and the RESCAL
tail-negative transpose).  Scoring is full fp32 (the caller keeps TF32
off), except in the training loss under --compute_dtype bfloat16: there
the rows come in as bf16 and each form keeps the JAX package's mix of
precisions, elementwise work and its reductions' results in bf16, every
matrix product with fp32 out (``matmul32``, the JAX einsums'
``preferred_element_type=float32``).
"""

from __future__ import annotations

import dataclasses
import math

import torch


class _MatmulF32(torch.autograd.Function):
    """a @ b with at least one bf16 operand, batch dims equal: the exact
    products accumulated and returned in fp32.  On the card two bf16
    operands take a bf16 tensor-core product with fp32 accumulation and
    output (``torch.bmm``'s ``out_dtype``); otherwise the operands are
    upcast, which gives the same exact products (a bf16 product fits fp32)
    accumulated in fp32.  The backward takes the fp32 cotangent against the
    other operand in fp32 and rounds to the operand's dtype, as JAX's
    transpose of such a product does."""

    @staticmethod
    def forward(ctx, a, b):
        if a.shape[:-2] != b.shape[:-2]:
            raise ValueError(f"matmul32: batch dims differ, {tuple(a.shape)} "
                             f"@ {tuple(b.shape)}")
        ctx.save_for_backward(a, b)
        if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
            out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                            b.reshape(-1, *b.shape[-2:]),
                            out_dtype=torch.float32)
            return out.reshape(*a.shape[:-1], b.shape[-1])
        return torch.matmul(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a.float().transpose(-1, -2), g).to(b.dtype)
        return ga, gb


def matmul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in fp32: torch.matmul for fp32 operands; with a bf16 operand
    (--compute_dtype bfloat16), _MatmulF32."""
    if a.dtype == b.dtype == torch.float32:
        return torch.matmul(a, b)
    return _MatmulF32.apply(a, b)


class _Abs(torch.autograd.Function):
    """|x| with the JAX package's subgradient at 0, +1 (torch.abs takes
    0 there).  An L1 component is exactly 0 far more often in bf16
    (--compute_dtype bfloat16) than in fp32."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def batched_l2_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a_i - b_j||_2 for batched a:[...,M,D], b:[...,N,D] -> [...,M,N],
    through the matmul expansion; clamped at 1e-30 before the sqrt to avoid
    NaN gradients at zero distance.  bf16 rows: the squared norms are summed
    into bf16 and the cross term comes out fp32, as in the JAX package."""
    a_sq = torch.sum(a * a, dim=-1)
    b_sq = torch.sum(b * b, dim=-1)
    ab = matmul32(a, b.transpose(-1, -2))
    sq = a_sq[..., :, None] + b_sq[..., None, :] - 2.0 * ab
    return torch.sqrt(torch.clamp(sq, min=1e-30))


def batched_l1_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a_i - b_j||_1 for batched a:[...,M,D], b:[...,N,D] -> [...,M,N];
    materializes the [..., M, N, D] broadcast."""
    return torch.sum(_Abs.apply(a[..., :, None, :] - b[..., None, :, :]),
                     dim=-1)


# Elements an infer_score block may hold in one intermediate (256 MB of
# fp32); the callers block over heads.
INFER_BUDGET = 1 << 26


def _norm(x: torch.Tensor, ord: int, dim: int = -1) -> torch.Tensor:
    if ord == 1:
        return torch.sum(_Abs.apply(x), dim=dim)
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

    def infer_score(self, head, rel, tail):
        """gamma - ||h + r - t|| as distances between the [H*R, D]
        translated heads and the [T, D] tails: the [H, R, T, D] difference
        is never formed."""
        hr = (head[:, None, :] + rel[None, :, :]).reshape(-1, head.shape[-1])
        d = torch.cdist(hr, tail, p=self.dist_ord,
                        compute_mode="donot_use_mm_for_euclid_dist")
        if self.dist_ord == 2:
            # _norm's +1e-30 inside the sqrt: a zero distance gives 1e-15;
            # any other distance comes back unchanged (sqrt(d*d) == d)
            d.square_().add_(1e-30).sqrt_()
        # gamma - d, in place: -d + gamma rounds as gamma - d does
        return d.neg_().add_(self.gamma).reshape(
            head.shape[0], rel.shape[0], tail.shape[0])


def _split(x: torch.Tensor):
    h = x.shape[-1] // 2
    return x[..., :h], x[..., h:]


def _chunk_dot(tmp, neg_emb, num_chunks, chunk_size, neg_sample_size):
    """[C, Bc, K] dot products of each chunk's [Bc, D] rows with its [K, D]
    negatives."""
    d = tmp.shape[-1]
    tmp = tmp.reshape(num_chunks, chunk_size, d)
    neg = neg_emb.reshape(num_chunks, neg_sample_size, d)
    return matmul32(tmp, neg.transpose(1, 2))


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
        """ent: [B, De], proj: [B, De*Dr] -> [B, Dr].  bf16 rows take a
        product with fp32 out, as the JAX package's einsum does: the
        broadcast form would round every product to bf16 before the sum."""
        p = proj.reshape(-1, self.entity_dim, self.relation_dim)
        if ent.dtype == p.dtype == torch.float32:
            return torch.sum(ent[:, :, None] * p, dim=1)
        return matmul32(ent[:, None, :], p)[:, 0, :]

    def neg_project(self, neg_ent, proj, num_chunks):
        """neg_ent: [C*K, De], proj: [B, De*Dr] -> [C, Bc, K, Dr] (fp32 out
        for bf16 rows: [K, De] @ [De, Bc*Dr] a chunk)."""
        p = proj.reshape(num_chunks, -1, self.entity_dim, self.relation_dim)
        n = neg_ent.reshape(num_chunks, -1, self.entity_dim)
        if n.dtype == p.dtype == torch.float32:
            return torch.einsum("ckd,cbdr->cbkr", n, p)
        c, bc = p.shape[:2]
        flat = p.permute(0, 2, 1, 3).reshape(c, self.entity_dim, -1)
        out = matmul32(n, flat).reshape(c, n.shape[1], bc, self.relation_dim)
        return out.permute(0, 2, 1, 3)

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
        return self.gamma - torch.sum(_Abs.apply(diff), dim=-1)

    def infer_score(self, head, rel, tail):
        raise NotImplementedError("TransR's all-pairs scores need the "
                                  "projection rows: transr_allpairs_score")


def transr_allpairs_score(h_emb, t_emb, proj, r_emb, gamma,
                          entity_dim: int, relation_dim: int,
                          budget: int = 1 << 25) -> torch.Tensor:
    """TransR scores [H, R, T] = gamma - |h P_r + r - t P_r|_1 for every
    (head, relation, tail); proj holds the relations' projection rows
    [R, De*Dr].  Relations are taken a tile at a time: each tile projects
    the heads and the tails with one batched matmul each and takes the L1
    distances with torch.cdist, so its largest intermediate is one of
    [Rt, H, T], [Rt, T, Dr] and [Rt, H, Dr], held under ``budget``
    elements."""
    proj = proj.reshape(-1, entity_dim, relation_dim)
    hn, tn, rn = h_emb.shape[0], t_emb.shape[0], r_emb.shape[0]
    per_rel = max(1, hn * tn, tn * relation_dim, hn * relation_dim)
    rt = max(1, min(rn, budget // per_rel))
    out = torch.empty((hn, rn, tn), dtype=torch.float32,
                      device=h_emb.device)
    for j in range(0, rn, rt):
        p = proj[j:j + rt]
        hp = torch.matmul(h_emb, p) + r_emb[j:j + rt, None, :]  # [Rt, H, Dr]
        tp = torch.matmul(t_emb, p)                             # [Rt, T, Dr]
        d = torch.cdist(hp, tp, p=1)
        out[:, j:j + rt] = d.neg_().add_(gamma).transpose(0, 1)
    return out


@dataclasses.dataclass(frozen=True)
class DistMultScore:
    name = "DistMult"

    def pos_score(self, head, rel, tail):
        return torch.sum(head * rel * tail, dim=-1)

    def neg_score(self, emb, rel, neg_emb, *, neg_head, num_chunks,
                  chunk_size, neg_sample_size):
        return _chunk_dot(emb * rel, neg_emb, num_chunks, chunk_size,
                          neg_sample_size)

    def infer_score(self, head, rel, tail):
        hr = head[:, None, :] * rel[None, :, :]                 # [H, R, D]
        return torch.matmul(hr, tail.T)


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

    def infer_score(self, head, rel, tail):
        re_h, im_h = _split(head)
        re_r, im_r = _split(rel)
        # the rotated heads [H, R, D/2] twice; [a | b] . [re_t | im_t] is
        # the JAX package's a . re_t + b . im_t in one product
        a = re_h[:, None, :] * re_r[None] - im_h[:, None, :] * im_r[None]
        b = im_h[:, None, :] * re_r[None] + re_h[:, None, :] * im_r[None]
        return torch.matmul(torch.cat([a, b], dim=-1), tail.T)


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
        rt = matmul32(self._mat(rel), tail[..., None])[..., 0]
        return torch.sum(head * rt, dim=-1)

    def neg_score(self, emb, rel, neg_emb, *, neg_head, num_chunks,
                  chunk_size, neg_sample_size):
        rmat = self._mat(rel)
        if neg_head:
            tmp = matmul32(rmat, emb[:, :, None])[:, :, 0]         # R t
        else:
            # h^T R, so that neg and pos scores agree (the JAX package's fix
            # of dgl-ke's (R h) . t')
            tmp = matmul32(emb[:, None, :], rmat)[:, 0, :]
        return _chunk_dot(tmp, neg_emb, num_chunks, chunk_size,
                          neg_sample_size)

    def infer_score(self, head, rel, tail):
        """h . (R t) for every (head, relation, tail).  With no more heads
        than tails h^T R is formed first (H R Dr De + H R T De
        multiply-adds), else R t as the JAX package does (R T Dr De +
        H R T Dr); relations are taken in blocks whose [Rb, min(H, T), D]
        and [Rb, H, T] intermediates stay under INFER_BUDGET elements."""
        mat = self._mat(rel)                                   # [R, Dr, De]
        hn, rn, tn = head.shape[0], mat.shape[0], tail.shape[0]
        width = max(self.relation_dim, self.entity_dim)
        rb = max(1, INFER_BUDGET // max(1, min(hn, tn) * width, hn * tn))
        out = torch.empty((hn, rn, tn), dtype=torch.float32,
                          device=head.device)
        for j in range(0, rn, rb):
            m = mat[j:j + rb]
            if hn <= tn:
                s = torch.matmul(torch.matmul(head, m), tail.T)
            else:
                s = torch.matmul(head, torch.matmul(m, tail.T))
            out[:, j:j + rb] = s.transpose(0, 1)               # [H, Rb, T]
        return out


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

    def infer_score(self, head, rel, tail):
        """The [H, R, T, D/2] moduli taken a block of tails at a time, each
        block under INFER_BUDGET elements."""
        re_h, im_h = _split(head)
        re_t, im_t = _split(tail)
        re_r, im_r = self._rotation(rel)
        re_hr = (re_h[:, None, :] * re_r[None] - im_h[:, None, :] * im_r[None])
        im_hr = (re_h[:, None, :] * im_r[None] + im_h[:, None, :] * re_r[None])
        hn, rn, half = re_hr.shape
        tn = tail.shape[0]
        tb = max(1, INFER_BUDGET // max(1, hn * rn * half))
        out = torch.empty((hn, rn, tn), dtype=torch.float32,
                          device=head.device)
        for j in range(0, tn, tb):
            re_s = re_hr[:, :, None, :] - re_t[None, None, j:j + tb]
            im_s = im_hr[:, :, None, :] - im_t[None, None, j:j + tb]
            dist = torch.sqrt(re_s * re_s + im_s * im_s + 1e-30)
            out[:, :, j:j + tb] = self.gamma - torch.sum(dist, dim=-1)
        return out


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

    def infer_score(self, head, rel, tail):
        h_i, h_j = _split(head)
        t_i, t_j = _split(tail)
        r, r_inv = _split(rel)
        fwd = torch.matmul(h_i[:, None, :] * r[None], t_j.T)
        bwd = torch.matmul(h_j[:, None, :] * r_inv[None], t_i.T)
        # no clamp: the reference's infer form does not clamp
        return 0.5 * (fwd + bwd)


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
