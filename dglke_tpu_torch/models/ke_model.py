"""KEModel: the training step and the full-entity eval (counterpart of
dglke_tpu/models/ke_model.py).

A batch is integer tensors (h, r, t, neg) and the step is

    gather rows (CUDA kernel) -> pos score -> chunked neg score -> loss
           -> torch.autograd.grad w.r.t. the GATHERED ROWS only
           -> row-sparse Adagrad write-back (CUDA kernel)

Gradients never reach the full tables, so the backward pass is O(batch).
Head-corrupt and tail-corrupt steps alternate (``neg_head``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.device import resolve_device
from dglke_tpu_torch.models.loss import LossGenerator, regularization
from dglke_tpu_torch.models.score_functions import make_score_function
from dglke_tpu_torch.ops.embedding import (
    EmbeddingState,
    gather_rows,
    init_embedding,
    sparse_adagrad_update,
)


class TrainState(nn.Module):
    """Entity and relation tables with their Adagrad state, and the step
    counter.  Updated in place by KEModel.train_step."""

    def __init__(self, entity: EmbeddingState, relation: EmbeddingState,
                 step: int = 0):
        super().__init__()
        self.entity = entity
        self.relation = relation
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
        return TrainState(entity, relation)

    # -- forward -------------------------------------------------------------

    def _pos_neg_scores(self, rows, rel_rows, neg_rows, *, neg_head: bool,
                        num_chunks: int, chunk_size: int,
                        neg_sample_size: int, neg_deg_sample: bool = False):
        """rows = (h_rows, t_rows): gathered entity rows [B, De] each.

        Returns (pos_score [B], neg_score [B, K'], K') where K' accounts for
        neg_deg_sample doubling; masked entries are zeroed."""
        h_rows, t_rows = rows
        sf = self.score_fn
        pos = sf.pos_score(h_rows, rel_rows, t_rows)
        side = t_rows if neg_head else h_rows
        k = neg_sample_size
        if neg_deg_sample:
            # The batch's own head/tail nodes are extra negatives; the
            # diagonal (each positive against itself) is masked to zero.
            own = (h_rows if neg_head else t_rows).reshape(
                num_chunks, chunk_size, -1)
            extra = neg_rows.reshape(num_chunks, neg_sample_size, -1)
            neg_rows = torch.cat([own, extra], dim=1).reshape(
                num_chunks * (chunk_size + neg_sample_size), -1)
            k = chunk_size + neg_sample_size
        neg = sf.neg_score(side, rel_rows, neg_rows, neg_head=neg_head,
                           num_chunks=num_chunks, chunk_size=chunk_size,
                           neg_sample_size=k)
        if neg_deg_sample:
            eye = torch.eye(chunk_size, k, dtype=neg.dtype, device=neg.device)
            neg = neg * (1.0 - eye)[None, :, :]
        return pos, neg.reshape(-1, k), k

    def loss_and_grads(self, state: TrainState, h, r, t, neg, impts, *,
                       neg_head: bool):
        """Loss and gradients w.r.t. the gathered rows.  Returns (loss,
        log, (ent_ids [3B+CK], ent_grads [3B+CK, De], rel_grads [B, Dr]))."""
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
        loss, log, grads = self._rows_loss_and_grads(
            ent_rows, rel_rows, impts, b=b, num_chunks=num_chunks,
            chunk_size=chunk_size, neg_sample_size=neg_sample_size,
            neg_head=neg_head)
        return loss, log, (ent_ids,) + grads

    def _rows_loss_and_grads(self, ent_rows, rel_rows, impts, *, b: int,
                             num_chunks: int, chunk_size: int,
                             neg_sample_size: int, neg_head: bool):
        """Loss + gradients w.r.t. already-gathered fp32 rows.  Returns
        (loss, log, (ent_grads, rel_grads)); log values are detached."""
        cfg = self.config
        ent_rows = ent_rows.detach().requires_grad_()
        rel_rows = rel_rows.detach().requires_grad_()
        with torch.enable_grad():
            h_rows, t_rows = ent_rows[:b], ent_rows[b:2 * b]
            neg_rows = ent_rows[2 * b:]
            pos, negs, _ = self._pos_neg_scores(
                (h_rows, t_rows), rel_rows, neg_rows, neg_head=neg_head,
                num_chunks=num_chunks, chunk_size=chunk_size,
                neg_sample_size=neg_sample_size,
                neg_deg_sample=cfg.neg_deg_sample)
            loss, log = self.loss_gen.get_total_loss(pos, negs, impts)
            if cfg.regularization_coef > 0.0 and cfg.regularization_norm > 0:
                # over the concatenated gathered rows, duplicates and
                # negatives included
                reg = regularization(cfg.regularization_coef,
                                     cfg.regularization_norm,
                                     [ent_rows, rel_rows])
                log["regularization"] = reg
                loss = loss + reg
            grads = torch.autograd.grad(loss, (ent_rows, rel_rows))
        log = {k: v.detach() for k, v in log.items()}
        return loss.detach(), log, grads

    # -- train step ----------------------------------------------------------

    def train_step(self, state: TrainState, h, r, t, neg, impts, *,
                   neg_head: bool):
        """One full step, IN PLACE on ``state``.  Returns (state, log)."""
        _, log, (ent_ids, ent_grads, rel_grads) = self.loss_and_grads(
            state, h, r, t, neg, impts, neg_head=neg_head)
        sparse_adagrad_update(state.entity, ent_ids, ent_grads,
                              self.config.lr)
        sparse_adagrad_update(state.relation, r, rel_grads, self.config.lr)
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
        pos, side, rel_rows = self._eval_pos_side(state, h, r, t,
                                                  neg_head=neg_head)
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
            counts += self._block_ge_counts(pos, side, rel_rows, cand, valid,
                                            local, in_blk, neg_head=neg_head)
        return torch.clamp(counts, min=0) + 1

    def _eval_block_size(self, b: int) -> int:
        """Candidate tile width for block-streamed full-entity eval."""
        if self.score_fn.name == "TransE_l2":
            return 16384   # matmul form: big candidate tiles
        # broadcast form (L1) materializes [B, block, D] per tile; budget it
        # to ~2^28 elements
        elems = max(1, b * max(self.entity_dim, self.relation_dim))
        pow2 = 1 << (max(1, (1 << 28) // elems).bit_length() - 1)
        return int(min(2048, max(32, pow2)))

    def _eval_pos_side(self, state: TrainState, h, r, t, *, neg_head: bool):
        """(pos [B], side rows [B, D], rel rows) in fp32: the positive score
        is the ranking threshold, so bf16 tables are upcast first."""
        h_rows = gather_rows(state.entity, h, self.entity_dim)
        t_rows = gather_rows(state.entity, t, self.entity_dim)
        rel_rows = gather_rows(state.relation, r, self.relation_dim)
        pos = self.score_fn.pos_score(h_rows, rel_rows, t_rows)
        return pos, (t_rows if neg_head else h_rows), rel_rows

    def _block_ge_counts(self, pos, side, rel_rows, cand, valid_cols, local,
                         in_blk, *, neg_head: bool):
        """GE-count of one candidate block minus its filtered count.

        Filtered candidates are counted by READING THE BLOCK'S OWN scores
        (a [B, F] gather from s) rather than re-scoring them: the
        comparison against pos is then bit-identical in both counts, so the
        subtraction is exact even for ties."""
        b = pos.shape[0]
        block = cand.shape[0]
        s = self.score_fn.neg_score(side, rel_rows, cand, neg_head=neg_head,
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
