"""KEModel: the training step and the full-entity eval (counterpart of
dglke_tpu/models/ke_model.py).

A batch is integer tensors (h, r, t, neg) and the step is

    gather rows (CUDA kernel) -> [project] -> pos score -> chunked neg
           score -> loss -> torch.autograd.grad w.r.t. the GATHERED ROWS only
           -> row-sparse Adagrad write-back (CUDA kernel)

Gradients never reach the full tables, so the backward pass is O(batch).
RESCAL with fp32 tables takes the gradient w.r.t. one vector per edge
instead of its relation rows, and writes the relation update through the
outer-product Adagrad kernel.  Head-corrupt and tail-corrupt steps
alternate (``neg_head``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.device import resolve_device
from dglke_tpu_torch.models.loss import LossGenerator, regularization
from dglke_tpu_torch.models.score_functions import (
    TransRScore,
    make_score_function,
)
from dglke_tpu_torch.ops.embedding import (
    EmbeddingState,
    gather_rows,
    init_embedding,
    sparse_adagrad_update,
)
from dglke_tpu_torch.ops.outer_update import outer_adagrad_update


class TrainState(nn.Module):
    """Entity and relation tables with their Adagrad state, TransR's
    projection table (None for the other families), and the step counter.
    Updated in place by KEModel.train_step."""

    def __init__(self, entity: EmbeddingState, relation: EmbeddingState,
                 step: int = 0, projection: Optional[EmbeddingState] = None):
        super().__init__()
        self.entity = entity
        self.relation = relation
        self.projection = projection
        self.step = int(step)


class KEModel:
    """Owns table shapes, the score function and the loss; the tables
    themselves live in a TrainState."""

    def __init__(self, config: KGEConfig, n_entities: int, n_relations: int,
                 device=None):
        config.validate()
        self.config = config
        self.device = resolve_device(device)
        self.n_entities = n_entities
        self.n_relations = n_relations
        self.score_fn, self.entity_dim, self.relation_dim = \
            make_score_function(config.model_name, config.gamma,
                                config.hidden_dim, config.double_ent,
                                config.double_rel)
        self.is_transr = isinstance(self.score_fn, TransRScore)
        self.proj_dim = self.entity_dim * self.relation_dim  # TransR only
        self.loss_gen = LossGenerator(
            loss_genre=config.loss_genre,
            neg_adversarial_sampling=config.neg_adversarial_sampling,
            adversarial_temperature=config.adversarial_temperature,
            pairwise=config.pairwise,
            margin=config.margin,
        )

    @property
    def table_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.config.emb_dtype == "bfloat16"
                else torch.float32)

    # -- state ---------------------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """Fresh tables drawn from ``generator`` (a generator on the model's
        device; seeded from config.seed when omitted)."""
        if generator is None:
            generator = torch.Generator(self.device)
            generator.manual_seed(self.config.seed)
        emb_init = self.config.emb_init
        entity = init_embedding(generator, self.n_entities, self.entity_dim,
                                emb_init, self.table_dtype, self.device)
        relation = init_embedding(generator, self.n_relations,
                                  self.relation_dim, emb_init,
                                  self.table_dtype, self.device)
        projection = None
        if self.is_transr:
            # the reference inits the projection with range 1.0
            projection = init_embedding(generator, self.n_relations,
                                        self.proj_dim, 1.0, self.table_dtype,
                                        self.device)
        return TrainState(entity, relation, projection=projection)

    # -- forward -------------------------------------------------------------

    def _pos_neg_scores(self, rows, rel_rows, neg_rows, proj_rows=None, *,
                        neg_head: bool, num_chunks: int, chunk_size: int,
                        neg_sample_size: int, neg_deg_sample: bool = False):
        """rows = (h_rows, t_rows): gathered entity rows [B, De] each;
        proj_rows: TransR's gathered projection rows, else None.

        Returns (pos_score [B], neg_score [B, K'], K') where K' accounts for
        neg_deg_sample doubling; masked entries are zeroed."""
        h_rows, t_rows = rows
        sf = self.score_fn
        if self.is_transr:
            h_rows = sf.project(h_rows, proj_rows)
            t_rows = sf.project(t_rows, proj_rows)
        pos = sf.pos_score(h_rows, rel_rows, t_rows)
        side = t_rows if neg_head else h_rows
        k = neg_sample_size
        if neg_deg_sample:
            # The batch's own head/tail nodes are extra negatives (RAW rows,
            # projected with the other negatives for TransR); the diagonal
            # (each positive against itself) is masked to zero.
            own = rows[0] if neg_head else rows[1]
            own = own.reshape(num_chunks, chunk_size, -1)
            extra = neg_rows.reshape(num_chunks, neg_sample_size, -1)
            neg_rows = torch.cat([own, extra], dim=1).reshape(
                num_chunks * (chunk_size + neg_sample_size), -1)
            k = chunk_size + neg_sample_size
        if self.is_transr:
            # every negative projected by every relation of its chunk
            neg_rows = sf.neg_project(neg_rows, proj_rows, num_chunks)
            side = side.reshape(num_chunks, chunk_size, self.relation_dim)
        neg = sf.neg_score(side, rel_rows, neg_rows, neg_head=neg_head,
                           num_chunks=num_chunks, chunk_size=chunk_size,
                           neg_sample_size=k)
        if neg_deg_sample:
            eye = torch.eye(chunk_size, k, dtype=neg.dtype, device=neg.device)
            neg = neg * (1.0 - eye)[None, :, :]
        return pos, neg.reshape(-1, k), k

    def _rescal_factored(self) -> bool:
        """RESCAL's factored route, the JAX package's fused one
        (ke_model.py:253-260) without its environment switch: fp32 tables
        and no neg_deg_sample."""
        cfg = self.config
        return (self.score_fn.name == "RESCAL" and not cfg.neg_deg_sample
                and cfg.emb_dtype != "bfloat16")

    def loss_and_grads(self, state: TrainState, h, r, t, neg, impts, *,
                       neg_head: bool):
        """Loss and gradients w.r.t. the gathered rows.  Returns (loss,
        log, (ent_ids [3B+CK], ent_grads [3B+CK, De], rel_grads,
        proj_grads or None)).  rel_grads is [B, Dr], or for RESCAL's
        factored route the rank-1 factors ("outer", a [B, Dr], b [B, De])."""
        b = h.shape[0]
        # Chunk structure: the batch splits into C chunks of Bc positives,
        # each sharing K = neg_sample_size negatives.
        num_chunks = max(1, neg.shape[0] // self.config.neg_sample_size)
        chunk_size = b // num_chunks
        neg_sample_size = neg.shape[0] // num_chunks
        # One entity gather for [h | t | neg]; the rows become leaves of
        # the autograd graph, so gradients stop at them.
        ent_ids = torch.cat([h, t, neg])
        ent_rows = gather_rows(state.entity, ent_ids, self.entity_dim)
        rel_rows = gather_rows(state.relation, r, self.relation_dim)
        chunks = dict(b=b, num_chunks=num_chunks, chunk_size=chunk_size,
                      neg_sample_size=neg_sample_size, neg_head=neg_head)
        if self._rescal_factored():
            loss, log, grads = self._rescal_loss_and_grads_factored(
                ent_rows, rel_rows, impts, **chunks)
        else:
            proj_rows = (gather_rows(state.projection, r, self.proj_dim)
                         if self.is_transr else None)
            loss, log, grads = self._rows_loss_and_grads(
                ent_rows, rel_rows, proj_rows, impts, **chunks)
        return loss, log, (ent_ids,) + grads

    def _rows_loss_and_grads(self, ent_rows, rel_rows, proj_rows, impts, *,
                             b: int, num_chunks: int, chunk_size: int,
                             neg_sample_size: int, neg_head: bool):
        """Loss + gradients w.r.t. already-gathered fp32 rows.  Returns
        (loss, log, (ent_grads, rel_grads, proj_grads or None)); log values
        are detached."""
        cfg = self.config
        leaves = [x.detach().requires_grad_() for x in
                  ([ent_rows, rel_rows] if proj_rows is None
                   else [ent_rows, rel_rows, proj_rows])]
        ent_rows, rel_rows = leaves[:2]

        def scores(ent_rows, rel_rows, *proj):
            return self._pos_neg_scores(
                (ent_rows[:b], ent_rows[b:2 * b]), rel_rows,
                ent_rows[2 * b:], proj[0] if proj else None,
                neg_head=neg_head, num_chunks=num_chunks,
                chunk_size=chunk_size, neg_sample_size=neg_sample_size,
                neg_deg_sample=cfg.neg_deg_sample)[:2]

        with torch.enable_grad():
            if self.score_fn.name == "RotatE":
                # recompute the [C, Bc, K, D/2] residuals in backward
                # instead of keeping them (the JAX package's jax.checkpoint)
                pos, negs = checkpoint(scores, *leaves, use_reentrant=False)
            else:
                pos, negs = scores(*leaves)
            loss, log = self.loss_gen.get_total_loss(pos, negs, impts)
            if cfg.regularization_coef > 0.0 and cfg.regularization_norm > 0:
                # over the concatenated gathered rows, duplicates and
                # negatives included
                reg = regularization(cfg.regularization_coef,
                                     cfg.regularization_norm,
                                     [ent_rows, rel_rows])
                log["regularization"] = reg
                loss = loss + reg
            grads = torch.autograd.grad(loss, leaves)
        if proj_rows is None:
            grads = grads + (None,)
        log = {k: v.detach() for k, v in log.items()}
        return loss.detach(), log, grads

    def _rescal_loss_and_grads_factored(self, ent_rows, rel_rows, impts, *,
                                        b: int, num_chunks: int,
                                        chunk_size: int, neg_sample_size: int,
                                        neg_head: bool):
        """RESCAL loss and gradients with the relation gradient kept as
        rank-1 factors (JAX: _rescal_loss_and_grads_factored).

        Tail-corrupt: tmp = R^T h gives pos = tmp.t and negs = tmp.n;
        head-corrupt: tmp = R t gives pos = h.tmp and negs = n.tmp.
        Differentiating w.r.t. tmp instead of the relation rows makes each
        edge's relation gradient an outer product, which the outer-product
        Adagrad kernel applies without forming the [B, Dr*De] array.  It
        also applies the relation rows' regularization gradient; only the
        value is computed here, for the loss and the log."""
        cfg = self.config
        sf = self.score_fn
        rmat = rel_rows.reshape(b, sf.relation_dim, sf.entity_dim)
        h0, t0 = ent_rows[:b], ent_rows[b:2 * b]
        if neg_head:
            tmp0 = torch.bmm(rmat, t0[:, :, None])[:, :, 0]
        else:
            tmp0 = torch.bmm(h0[:, None, :], rmat)[:, 0, :]
        ent_rows = ent_rows.detach().requires_grad_()
        tmp = tmp0.detach().requires_grad_()
        reg_on = cfg.regularization_coef > 0.0 and cfg.regularization_norm > 0
        with torch.enable_grad():
            side = ent_rows[:b] if neg_head else ent_rows[b:2 * b]
            pos = torch.sum(side * tmp, dim=-1)
            negs = torch.matmul(
                tmp.reshape(num_chunks, chunk_size, -1),
                ent_rows[2 * b:].reshape(num_chunks, neg_sample_size,
                                         -1).transpose(1, 2))
            loss, log = self.loss_gen.get_total_loss(
                pos, negs.reshape(-1, neg_sample_size), impts)
            if reg_on:
                # entity rows only: the kernel applies the relation rows'
                reg = regularization(cfg.regularization_coef,
                                     cfg.regularization_norm, [ent_rows])
                log["regularization"] = reg
                loss = loss + reg
            g_ent, g_tmp = torch.autograd.grad(loss, (ent_rows, tmp))
        if neg_head:
            # tmp = R t: dt += R^T g_tmp; dR = g_tmp (x) t
            g_ent[b:2 * b] += torch.bmm(g_tmp[:, None, :], rmat)[:, 0, :]
            factors = (g_tmp, t0)
        else:
            # tmp = R^T h: dh += R g_tmp; dR = h (x) g_tmp
            g_ent[:b] += torch.bmm(rmat, g_tmp[:, :, None])[:, :, 0]
            factors = (h0, g_tmp)
        if reg_on:
            reg_rel = regularization(cfg.regularization_coef,
                                     cfg.regularization_norm, [rel_rows])
            log["regularization"] = log["regularization"] + reg_rel
            loss = loss + reg_rel
        log = {k: v.detach() for k, v in log.items()}
        return loss.detach(), log, (g_ent, ("outer",) + factors, None)

    # -- train step ----------------------------------------------------------

    def train_step(self, state: TrainState, h, r, t, neg, impts, *,
                   neg_head: bool):
        """One full step, IN PLACE on ``state``.  Returns (state, log)."""
        cfg = self.config
        _, log, (ent_ids, ent_grads, rel_grads, proj_grads) = \
            self.loss_and_grads(state, h, r, t, neg, impts,
                                neg_head=neg_head)
        sparse_adagrad_update(state.entity, ent_ids, ent_grads, cfg.lr)
        if isinstance(rel_grads, tuple) and rel_grads[0] == "outer":
            outer_adagrad_update(state.relation, r, rel_grads[1],
                                 rel_grads[2], cfg.lr,
                                 reg_coef=cfg.regularization_coef,
                                 reg_norm=cfg.regularization_norm)
        else:
            sparse_adagrad_update(state.relation, r, rel_grads, cfg.lr)
        if self.is_transr:
            sparse_adagrad_update(state.projection, r, proj_grads, cfg.lr)
        state.step += 1
        return state, log

    # -- evaluation ----------------------------------------------------------

    @torch.no_grad()
    def eval_ranks(self, state: TrainState, h, r, t, filter_ids,
                   filter_mask, *, neg_head: bool,
                   block: Optional[int] = None) -> torch.Tensor:
        """Filtered ranks of each (h, r, t) against ALL entities.

        rank_i = 1 + |{e not filtered : score_i(e) >= pos_i}|, computed as
        (total count >= pos) - (count over the filtered list >= pos), with
        the true entity itself a member of the filtered list.  filter_ids:
        [B, F] padded entity ids of known true triples; filter_mask: [B, F]
        nonzero for real entries.  Blocked over the entity axis."""
        b = h.shape[0]
        if block is None:
            block = self._eval_block_size(b)
        pos, side, rel_rows, proj_rows = self._eval_pos_side(
            state, h, r, t, neg_head=neg_head)
        n_ent = self.n_entities
        n_rows = state.entity.emb.shape[0]
        dev = pos.device
        counts = torch.zeros(b, dtype=torch.int64, device=dev)
        for start in range(0, n_ent, block):
            if n_rows >= block:
                # The candidate block is a contiguous slice.  The tail
                # block's start is clamped so the slice stays in bounds;
                # rows below `start` were scored by earlier blocks and are
                # masked out of both counts.
                cs = min(start, n_rows - block)
                cand = state.entity.emb[cs:cs + block,
                                        :self.entity_dim].float()
                gids = cs + torch.arange(block, device=dev)
                valid = (gids >= start) & (gids < n_ent)
                local = filter_ids - cs
                in_blk = ((filter_ids >= start) & (local < block)
                          & (filter_mask > 0))
            else:
                ids = start + torch.arange(block, device=dev,
                                           dtype=torch.int32)
                cand = gather_rows(state.entity,
                                   torch.clamp(ids, max=n_ent - 1),
                                   self.entity_dim)
                valid = ids < n_ent
                local = filter_ids - start
                in_blk = (local >= 0) & (local < block) & (filter_mask > 0)
            counts += self._block_ge_counts(pos, side, rel_rows, proj_rows,
                                            cand, valid, local, in_blk,
                                            neg_head=neg_head)
        return torch.clamp(counts, min=0) + 1

    def _eval_block_size(self, b: int) -> int:
        """Candidate tile width for block-streamed full-entity eval."""
        if self.score_fn.name in ("TransE_l2", "DistMult", "ComplEx",
                                  "RESCAL", "SimplE"):
            return 16384   # matmul form: big candidate tiles
        # broadcast forms (L1, RotatE, TransR) materialize a [B, block,
        # D]-scale intermediate per tile; budget it to ~2^28 elements
        elems = max(1, b * max(self.entity_dim, self.relation_dim))
        pow2 = 1 << (max(1, (1 << 28) // elems).bit_length() - 1)
        return int(min(2048, max(32, pow2)))

    def _eval_pos_side(self, state: TrainState, h, r, t, *, neg_head: bool):
        """(pos [B], side rows [B, D], rel rows, TransR's projection rows
        or None) in fp32: the positive score is the ranking threshold, so
        bf16 tables are upcast first.  TransR's side rows come projected."""
        sf = self.score_fn
        h_rows = gather_rows(state.entity, h, self.entity_dim)
        t_rows = gather_rows(state.entity, t, self.entity_dim)
        rel_rows = gather_rows(state.relation, r, self.relation_dim)
        proj_rows = None
        if self.is_transr:
            proj_rows = gather_rows(state.projection, r, self.proj_dim)
            h_rows = sf.project(h_rows, proj_rows)
            t_rows = sf.project(t_rows, proj_rows)
        pos = sf.pos_score(h_rows, rel_rows, t_rows)
        return pos, (t_rows if neg_head else h_rows), rel_rows, proj_rows

    def _block_ge_counts(self, pos, side, rel_rows, proj_rows, cand,
                         valid_cols, local, in_blk, *, neg_head: bool):
        """GE-count of one candidate block minus its filtered count.

        Filtered candidates are counted by READING THE BLOCK'S OWN scores
        (a [B, F] gather from s) rather than re-scoring them: the
        comparison against pos is then bit-identical in both counts, so the
        subtraction is exact even for ties."""
        sf = self.score_fn
        b = pos.shape[0]
        block = cand.shape[0]
        if self.is_transr:
            cand = sf.neg_project(cand, proj_rows, 1)
            side = side.reshape(1, b, -1)
        s = sf.neg_score(side, rel_rows, cand, neg_head=neg_head,
                         num_chunks=1, chunk_size=b,
                         neg_sample_size=block).reshape(b, block)
        ge = (s >= pos[:, None]) & valid_cols[None, :]
        fs = torch.gather(s, 1, torch.clamp(local, 0, block - 1).long())
        fge = torch.sum((fs >= pos[:, None]) & in_blk, dim=1)
        return torch.sum(ge, dim=1) - fge


def metrics_from_ranks(ranks: np.ndarray) -> Dict[str, float]:
    """MRR / MR / HITS@{1,3,10} averaged over the ranks."""
    ranks = np.asarray(ranks, dtype=np.float64)
    return {
        "MRR": float(np.mean(1.0 / ranks)),
        "MR": float(np.mean(ranks)),
        "HITS@1": float(np.mean(ranks <= 1)),
        "HITS@3": float(np.mean(ranks <= 3)),
        "HITS@10": float(np.mean(ranks <= 10)),
    }
