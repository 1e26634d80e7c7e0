"""Inference: top-K link prediction and embedding similarity (counterpart
of dglke_tpu/models/infer.py).

  * ScoreInfer: a checkpoint's config.json and npy tables; (h, r, t) id
    lists scored under 5 exec modes (triplet_wise / all / batch_head /
    batch_rel / batch_tail), optionally squashed by logsigmoid, top-K with
    the divmod decode of the flat index.  TransR is served (each relation
    projects its heads and tails).
  * EmbSimInfer: similarity top-K over the rows of one npy table with 5
    similarity functions (cosine / l2 / l1 / dot / ext_jaccard), pairwise,
    all pairs or a row per left id.

On the device: a table moves there once, at load; the ids go there as
int32 and every served row comes out of K1 (ops/rows.gather_rows); the
scores and the top-K stay there and only the K results come back.  The
top-K keeps the JAX package's order, np.argsort(-score, kind="stable"):
highest first and, among equal scores, lower flat index first
(topk_desc).  The decode is integer arithmetic on the host.  The scoring
core here (scored_blocks, sim_topk) serves the object API of
models/ge_model.py too.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.device import resolve_api_device
from dglke_tpu_torch.models.score_functions import (
    TransRScore,
    make_score_function,
    transr_allpairs_score,
)
from dglke_tpu_torch.ops.rows import gather_rows

DEFAULT_INFER_BATCHSIZE = 1024
EXEC_MODES = ("triplet_wise", "all", "batch_head", "batch_rel", "batch_tail")


# ---------------------------------------------------------------------------
# Similarity functions: [L, D] x [R, D] -> [L, R], or pairwise [N] (pw)


def l2_sim(x, y, pw=False):
    if pw:
        return -torch.sqrt(torch.sum((x - y) ** 2, dim=-1))
    return -torch.cdist(x, y, p=2,
                        compute_mode="donot_use_mm_for_euclid_dist")


def l1_sim(x, y, pw=False):
    if pw:
        return -torch.sum(torch.abs(x - y), dim=-1)
    return -torch.cdist(x, y, p=1)


def dot_sim(x, y, pw=False):
    if pw:
        return torch.sum(x * y, dim=-1)
    return torch.matmul(x, y.T)


def cosine_sim(x, y, pw=False):
    score = dot_sim(x, y, pw)
    nx = torch.sqrt(torch.sum(x * x, dim=-1))
    ny = torch.sqrt(torch.sum(y * y, dim=-1))
    if not pw:
        nx, ny = nx[:, None], ny[None, :]
    return score / (nx * ny)


def ext_jaccard_sim(x, y, pw=False):
    score = dot_sim(x, y, pw)
    nx = torch.sum(x * x, dim=-1)
    ny = torch.sum(y * y, dim=-1)
    if not pw:
        nx, ny = nx[:, None], ny[None, :]
    return score / (nx + ny - score)


SIM_FUNCS = {
    "cosine": cosine_sim,
    "l2": l2_sim,
    "l1": l1_sim,
    "dot": dot_sim,
    "ext_jaccard": ext_jaccard_sim,
}


# ---------------------------------------------------------------------------
# The scoring core


def topk_desc(score: torch.Tensor, k: int) -> torch.Tensor:
    """The positions of the k highest entries of each row of ``score`` ([N]
    or [L, N]), highest first and, among equal scores, lower position
    first: np.argsort(-row, kind="stable")[:k].  torch.topk leaves the
    order of equal scores open, so it only finds the k-th highest value;
    the entries above it and the first of those equal to it are then taken
    by position and sorted stably."""
    rows = score[None] if score.dim() == 1 else score
    n = rows.shape[1]
    k = min(k, n)
    if k <= 0:
        idx = rows.new_empty((rows.shape[0], 0), dtype=torch.int64)
    elif k == n:
        idx = torch.sort(rows, dim=1, descending=True, stable=True).indices
    else:
        kth = torch.topk(rows, k, dim=1).values[:, -1:]
        above = rows > kth
        tied = rows == kth
        need = k - above.sum(dim=1, keepdim=True)
        take = above | (tied & (torch.cumsum(tied, 1, dtype=torch.int32)
                                <= need))
        pos = torch.nonzero(take)[:, 1].reshape(-1, k)   # ascending
        order = torch.sort(torch.gather(rows, 1, pos), dim=1,
                           descending=True, stable=True).indices
        idx = torch.gather(pos, 1, order)
    return idx[0] if score.dim() == 1 else idx


def device_ids(ids: np.ndarray, n: int, device, what: str) -> torch.Tensor:
    """Host ids -> int32 ids on ``device``; ids outside [0, n) raise."""
    ids = np.asarray(ids)
    if ids.size and (ids.min() < 0 or ids.max() >= n):
        raise IndexError(f"{what} ids outside [0, {n})")
    return torch.as_tensor(ids.astype(np.int32), device=device)


def table_on(device, array) -> torch.Tensor:
    """A table as fp32 on ``device`` (moved once)."""
    return torch.as_tensor(np.asarray(array), dtype=torch.float32).to(device)


def triplet_scores(sf, h, r, t, projection=None, rel_ids=None,
                   batch_size: int = DEFAULT_INFER_BATCHSIZE):
    """[B] scores of the rows of B triples.  TransR projects each triple's
    rows by its relation's [De, Dr] projection row, gathered by K1 from
    ``projection`` at ``rel_ids``, batch_size triples at a time."""
    if not isinstance(sf, TransRScore):
        return sf.pos_score(h, r, t)
    out = torch.empty((h.shape[0],), dtype=torch.float32, device=h.device)
    for i in range(0, h.shape[0], batch_size):
        blk = slice(i, i + batch_size)
        p = gather_rows(projection, rel_ids[blk]).view(
            -1, sf.entity_dim, sf.relation_dim)
        hp = torch.bmm(h[blk, None, :], p)[:, 0]
        tp = torch.bmm(t[blk, None, :], p)[:, 0]
        out[blk] = sf.pos_score(hp, r[blk], tp)
    return out


def all_pairs_scores(sf, h, r, t, proj_rows=None,
                     batch_size: int = DEFAULT_INFER_BATCHSIZE):
    """[H, R, T] scores of every (head row, relation row, tail row), heads
    batch_size at a time; TransR's proj_rows are the relations'
    projection rows."""
    if isinstance(sf, TransRScore):
        return transr_allpairs_score(h, t, proj_rows, r, sf.gamma,
                                     sf.entity_dim, sf.relation_dim)
    out = torch.empty((h.shape[0], r.shape[0], t.shape[0]),
                      dtype=torch.float32, device=h.device)
    for i in range(0, h.shape[0], batch_size):
        out[i:i + batch_size] = sf.infer_score(h[i:i + batch_size], r, t)
    return out


def mode_blocks(exec_mode: str, nh: int, nr: int, nt: int):
    """The (heads, relations, tails) slices of each result element of
    ``exec_mode``: the whole lists for triplet_wise and all, one head,
    relation or tail for batch_head, batch_rel and batch_tail."""
    every = slice(None)
    if exec_mode in ("triplet_wise", "all"):
        return [(every, every, every)]
    if exec_mode == "batch_head":
        return [(slice(i, i + 1), every, every) for i in range(nh)]
    if exec_mode == "batch_rel":
        return [(every, slice(i, i + 1), every) for i in range(nr)]
    if exec_mode == "batch_tail":
        return [(every, every, slice(i, i + 1)) for i in range(nt)]
    raise ValueError(f"unknown execution mode type {exec_mode}")


def scored_blocks(sf, entity, relation, projection, head, rel, tail,
                  exec_mode: str, batch_size: int = DEFAULT_INFER_BATCHSIZE):
    """Score the (head, rel, tail) id lists (host int arrays) under
    ``exec_mode`` on the tables' device.  Yields, for each result element,
    its flat scores and the head, rel and tail ids of its block: [N] for
    triplet_wise (position i is the i-th triple), else [H*R*T] in [H, R,
    T] order.  K1 gathers the rows once: heads, relations, tails and, for
    TransR's all pairs, the relations' projection rows."""
    blocks = mode_blocks(exec_mode, len(head), len(rel), len(tail))
    if exec_mode == "triplet_wise" and not len(head) == len(rel) == len(tail):
        raise ValueError(
            "triplet_wise scoring pairs elementwise: head/rel/tail lengths "
            f"must match (got {len(head)}/{len(rel)}/{len(tail)})")
    dev = entity.device
    rid = device_ids(rel, relation.shape[0], dev, "relation")
    h = gather_rows(entity, device_ids(head, entity.shape[0], dev, "head"))
    r = gather_rows(relation, rid)
    t = gather_rows(entity, device_ids(tail, entity.shape[0], dev, "tail"))
    if exec_mode == "triplet_wise":
        yield (triplet_scores(sf, h, r, t, projection, rid, batch_size),
               head, rel, tail)
        return
    p = (gather_rows(projection, rid) if isinstance(sf, TransRScore)
         else None)
    for hs, rs, ts in blocks:
        s = all_pairs_scores(sf, h[hs], r[rs], t[ts],
                             None if p is None else p[rs], batch_size)
        yield s.reshape(-1), head[hs], rel[rs], tail[ts]


def squash(score: torch.Tensor, sfunc: str) -> torch.Tensor:
    return F.logsigmoid(score) if sfunc == "logsigmoid" else score


def decode(idx: np.ndarray, head, rel, tail, triplet_wise: bool):
    """Flat indices -> (head, rel, tail) ids: the i-th triple of a
    triplet_wise list, else the divmod decode of an index into the [H, R,
    T] block."""
    if triplet_wise:
        return head[idx], rel[idx], tail[idx]
    nr, nt = len(rel), len(tail)
    hr = idx // nt
    return head[hr // nr], rel[hr % nr], tail[idx % nt]


def top_results(score: torch.Tensor, k: int, head, rel, tail,
                triplet_wise: bool):
    """(heads, rels, tails, scores) of the k highest scores, numpy."""
    idx = topk_desc(score, k)
    s = score[idx].cpu().numpy()
    return (*decode(idx.cpu().numpy(), head, rel, tail, triplet_wise), s)


def sim_topk(emb: torch.Tensor, left, right, sim, bcast: bool,
             pair_ws: bool, k: int,
             batch_size: int = DEFAULT_INFER_BATCHSIZE) -> List[Tuple]:
    """Similarity top-K between the rows ``left`` and ``right`` (host id
    arrays) of ``emb``: [(left ids, right ids, scores)], one element for
    pairwise and all pairs, one per left id for bcast."""
    dev = emb.device
    l_emb = gather_rows(emb, device_ids(left, emb.shape[0], dev, "left"))
    r_emb = gather_rows(emb, device_ids(right, emb.shape[0], dev, "right"))
    if pair_ws:
        if len(left) != len(right):
            raise ValueError("pairwise similarity needs left and right "
                             f"lists of one length ({len(left)}, "
                             f"{len(right)})")
        score = torch.empty((len(left),), dtype=torch.float32, device=dev)
        for i in range(0, len(left), batch_size):
            score[i:i + batch_size] = sim(l_emb[i:i + batch_size],
                                          r_emb[i:i + batch_size], pw=True)
        idx = topk_desc(score, k)
        s = score[idx].cpu().numpy()
        idx = idx.cpu().numpy()
        return [(left[idx], right[idx], s)]
    score = torch.empty((len(left), len(right)), dtype=torch.float32,
                        device=dev)
    for i in range(0, len(left), batch_size):
        score[i:i + batch_size] = sim(l_emb[i:i + batch_size], r_emb)
    if not bcast:
        flat = score.reshape(-1)
        idx = topk_desc(flat, k)
        s = flat[idx].cpu().numpy()
        idx = idx.cpu().numpy()
        return [(left[idx // len(right)], right[idx % len(right)], s)]
    idx = topk_desc(score, k)
    s = torch.gather(score, 1, idx).cpu().numpy()
    idx = idx.cpu().numpy()
    return [(np.full((idx.shape[1],), left[i]), right[idx[i]], s[i])
            for i in range(len(left))]


# ---------------------------------------------------------------------------
# InferModel, ScoreInfer, EmbSimInfer


class InferModel:
    """Scores (head, rel, tail) id combinations against a checkpoint's npy
    tables, held on the device (reference InferModel)."""

    def __init__(self, config: KGEConfig, batch_size: int = 32,
                 device=None):
        self.config = config
        self.score_fn, self.entity_dim, self.relation_dim = \
            make_score_function(config.model_name, config.gamma,
                                config.hidden_dim, config.double_ent,
                                config.double_rel)
        self.is_transr = isinstance(self.score_fn, TransRScore)
        self.batch_size = batch_size
        self.device = resolve_api_device(device)
        self.entity_emb = self.relation_emb = self.projection_emb = None

    def load_emb(self, path: str, dataset: str):
        prefix = os.path.join(path, f"{dataset}_{self.config.model_name}_")
        self.entity_emb = table_on(self.device, np.load(prefix + "entity.npy"))
        self.relation_emb = table_on(self.device,
                                     np.load(prefix + "relation.npy"))
        if self.is_transr:
            proj = prefix + "projection.npy"
            if not os.path.exists(proj):
                # dgl-ke's spelling, without the separating underscore
                proj = prefix[:-1] + "projection.npy"
            self.projection_emb = table_on(self.device, np.load(proj))

    @property
    def num_entity(self):
        return self.entity_emb.shape[0]

    @property
    def num_rel(self):
        return self.relation_emb.shape[0]

    def blocks(self, head, rel, tail, exec_mode: str):
        return scored_blocks(self.score_fn, self.entity_emb,
                             self.relation_emb, self.projection_emb, head,
                             rel, tail, exec_mode, self.batch_size)

    def score(self, head, rel, tail,
              triplet_wise: bool = False) -> torch.Tensor:
        """Flattened scores on the device: [H*R*T] (all pairs) or [B]."""
        (s, *_), = self.blocks(np.asarray(head), np.asarray(rel),
                               np.asarray(tail),
                               "triplet_wise" if triplet_wise else "all")
        return s


class ScoreInfer:
    """Top-K link prediction over a saved checkpoint (reference
    models/infer.py ScoreInfer).  ``device``: "cuda" (the default), "cpu",
    or the JAX package's integer gpu id, which selects the card."""

    def __init__(self, device, config, model_path: str, sfunc: str = "none"):
        if sfunc not in ("none", "logsigmoid"):
            raise ValueError("sfunc must be 'none' or 'logsigmoid'")
        if isinstance(config, dict):
            fields = {f.name for f in dataclasses.fields(KGEConfig)}
            config = KGEConfig(**{k: v for k, v in config.items()
                                  if k in fields})
        self.config = config
        self.model_path = model_path
        self.sfunc = sfunc
        self.device = device

    def load_model(self):
        cfg = self.config
        if self.sfunc == "none":
            # gamma 0: raw translational scores are negative distances
            cfg = dataclasses.replace(cfg, gamma=0.0)
        self.model = InferModel(cfg, device=self.device)
        self.model.load_emb(self.model_path, self.config.dataset)

    def topK(self, head=None, rel=None, tail=None, exec_mode="all",
             k: int = 10) -> List[Tuple]:
        m = self.model
        head = np.arange(m.num_entity) if head is None else np.asarray(head)
        rel = np.arange(m.num_rel) if rel is None else np.asarray(rel)
        tail = np.arange(m.num_entity) if tail is None else np.asarray(tail)
        return [top_results(squash(s, self.sfunc), k, h, r, t,
                            exec_mode == "triplet_wise")
                for s, h, r, t in m.blocks(head, rel, tail, exec_mode)]


class EmbSimInfer:
    """Top-K embedding similarity over one npy table (reference
    models/infer.py EmbSimInfer)."""

    def __init__(self, device, emb_file: str, sfunc: str = "cosine",
                 batch_size: int = DEFAULT_INFER_BATCHSIZE):
        self.emb_file = emb_file
        self.sfunc = sfunc
        self.sim_func = SIM_FUNCS[sfunc]
        self.batch_size = batch_size
        self.device = resolve_api_device(device)

    def load_emb(self):
        self.emb = table_on(self.device, np.load(self.emb_file))

    def topK(self, head=None, tail=None, bcast=False, pair_ws=False,
             k: int = 10) -> List[Tuple]:
        n = self.emb.shape[0]
        head = np.arange(n) if head is None else np.asarray(head)
        tail = np.arange(n) if tail is None else np.asarray(tail)
        return sim_topk(self.emb, head, tail, self.sim_func, bcast, pair_ws,
                        k, self.batch_size)
