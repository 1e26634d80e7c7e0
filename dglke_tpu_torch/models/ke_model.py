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

The same step trains tables in host memory (host_table.HostState,
--mix_cpu_gpu): on a card K1 reads them over the host link and each K2
update starts from the rows K1 gathered in the step, which a mapped table
needs; RESCAL takes the plain row route there, as the JAX package's host
mode does.

Under a parallel.mesh.ShardingPlan (--dist) each rank steps on its own
slice of the global batch: its loss is scaled by its share of the global
batch, entity rows come through the plan (K1 on the owner's shard under
vocab sharding), and every update goes through the plan to the tables'
owners or replicas (K2, and K3 on RESCAL's relation replicas).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.device import resolve_device
from dglke_tpu_torch.models.eval_step import EvalCalls
from dglke_tpu_torch.models.loss import LossGenerator, regularization
from dglke_tpu_torch.models.score_functions import (
    TransEScore,
    TransRScore,
    make_score_function,
)
from dglke_tpu_torch.ops import transe_l2
from dglke_tpu_torch.ops.embedding import (
    EmbeddingState,
    gather_rows,
    gather_rows_matvec,
    init_embedding,
    sparse_adagrad_update,
)
from dglke_tpu_torch.ops.outer_update import outer_adagrad_update

# The loss the fused TransE_l2 route computes (KEModel._transe_l2_fused).
_FUSED_TOTAL_LOSS = LossGenerator.get_total_loss

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
                 device=None, plan=None):
        config.validate()
        self.config = config
        # a rank of a --dist run runs on its plan's device
        self.plan = plan
        self.device = (plan.device if plan is not None and device is None
                       else resolve_device(device))
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
        # the eval's fused calls, memoized per call shape and tables
        self.eval_calls = EvalCalls(self)

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

    def _rescal_factored(self, state) -> bool:
        """RESCAL's factored route on ``state``, the JAX package's fused one
        (ke_model.py:253-260) without its environment switch: fp32 tables,
        fp32 compute, no neg_deg_sample, and tables in a TrainState (on the
        card or the CPU).  Host tables take the plain row route on every
        device, as the JAX package's host mode does."""
        cfg = self.config
        return (self.score_fn.name == "RESCAL" and not cfg.neg_deg_sample
                and cfg.compute_dtype != "bfloat16"
                and cfg.emb_dtype != "bfloat16"
                and not getattr(state, "is_host", False))

    def _transe_l2_fused(self, ent_rows=None, rel_rows=None,
                         **chunks) -> bool:
        """TransE_l2's fused loss route (ops/transe_l2.py) in place of
        autograd: TransE with the L2 distance, fp32 compute and tables,
        the pointwise Logsigmoid loss and no neg_deg_sample; given the
        gathered rows and the chunk shape (b, num_chunks, chunk_size,
        neg_sample_size), also rows of that layout (transe_l2.fits).

        The route computes TransEScore's scores and LossGenerator's
        get_total_loss itself, so a score function or a loss generator
        whose class replaces them (a subclass, or a patch of the class)
        keeps the autograd route, which calls what replaced them."""
        cfg, sf, lg = self.config, self.score_fn, self.loss_gen
        fused = (type(sf) is TransEScore and sf.dist_ord == 2
                 and type(lg).get_total_loss is _FUSED_TOTAL_LOSS
                 and cfg.compute_dtype != "bfloat16"
                 and cfg.emb_dtype != "bfloat16"
                 and lg.loss_genre == "Logsigmoid" and not lg.pairwise
                 and not cfg.neg_deg_sample)
        if fused and ent_rows is not None:
            fused = transe_l2.fits(ent_rows, rel_rows, **chunks)
        return fused

    def loss_and_grads(self, state: TrainState, h, r, t, neg, impts, *,
                       neg_head: bool):
        """Loss and gradients w.r.t. the gathered rows.  Returns (loss,
        log, (ent_ids [3B+CK], ent_grads [3B+CK, De], rel_grads,
        proj_grads or None)); under vocab sharding ent_ids is the
        parallel.mesh.Route of the gather, which the update reuses.  rel_grads is [B, Dr], or for RESCAL's
        factored route the rank-1 factors ("outer", a [B, Dr], b [B, De])."""
        return self._grads_and_rows(state, h, r, t, neg, impts,
                                    neg_head=neg_head)[:3]

    def _grads_and_rows(self, state, h, r, t, neg, impts, *,
                        neg_head: bool):
        """loss_and_grads, and the rows gathered for the updates: on host
        tables (entity rows, relation rows, TransR's projection rows or
        None), which their K2 updates start from; on a TrainState None, so
        that no gathered copy outlives the step's loss.  A batch off the
        model's device is refused on host tables, whose plain versions
        would otherwise take ids on the CPU: the step moves nothing between
        the host and the card."""
        host = getattr(state, "is_host", False)
        if host:
            for x in (h, r, t, neg, impts):
                if x is not None and x.device.type != self.device.type:
                    raise ValueError(
                        f"a host-table step on a batch on {x.device} for a "
                        f"model on {self.device} (the step moves nothing; "
                        f"host_table.host_step uploads a batch)")
        b = h.shape[0]
        # Chunk structure: the batch splits into C chunks of Bc positives,
        # each sharing K = neg_sample_size negatives.
        num_chunks = max(1, neg.shape[0] // self.config.neg_sample_size)
        chunk_size = b // num_chunks
        neg_sample_size = neg.shape[0] // num_chunks
        # One entity gather for [h | t | neg]; the rows become leaves of
        # the autograd graph, so gradients stop at them.
        ent_rows, ent_ids = self._gather_entity(state, torch.cat([h, t, neg]))
        chunks = dict(b=b, num_chunks=num_chunks, chunk_size=chunk_size,
                      neg_sample_size=neg_sample_size, neg_head=neg_head)
        if self._rescal_factored(state):
            # the relation rows come with their regularization value and
            # their product with the edges' entity vectors (both formed by
            # K1 as it copies them on the card); K3 applies the value's
            # gradient
            cfg = self.config
            reg_on = (cfg.regularization_coef > 0.0
                      and cfg.regularization_norm > 0)
            vecs = ent_rows[b:2 * b] if neg_head else ent_rows[:b]
            rel_rows, rel_pow_sum, tmp0 = gather_rows_matvec(
                state.relation, r, vecs, neg_head,
                cfg.regularization_norm if reg_on else 0, self.relation_dim)
            loss, log, grads = self._rescal_loss_and_grads_factored(
                ent_rows, rel_rows, rel_pow_sum, tmp0, impts, **chunks)
        else:
            rel_rows = gather_rows(state.relation, r, self.relation_dim)
            proj_rows = (gather_rows(state.projection, r, self.proj_dim)
                         if self.is_transr else None)
            loss, log, grads = self._rows_loss_and_grads(
                ent_rows, rel_rows, proj_rows, impts, **chunks)
        rows = (ent_rows, rel_rows, proj_rows) if host else None
        return loss, log, (ent_ids,) + grads, rows

    def _gather_entity(self, state: TrainState, ids):
        """fp32 entity rows at ``ids`` and what the update of those rows
        takes: the ids, or under vocab sharding the plan's Route (the rows
        gathered by K1 on their owners' shards)."""
        if self.plan is not None and self.plan.vocab:
            return self.plan.routed_gather(state.entity, ids,
                                           self.entity_dim)
        return gather_rows(state.entity, ids, self.entity_dim), ids

    def _share(self) -> float:
        """This rank's share of the global batch: 1/n under a plan of n
        ranks, else 1."""
        return 1.0 if self.plan is None or self.plan.n == 1 else \
            1.0 / self.plan.n

    def _batch_share(self, loss, log):
        """Under a plan, this rank's part of the global batch's mean loss
        (and log values): each rank's mean scaled by 1/n, so that the
        gradients summed over the ranks are those of the global mean.  The
        regularization is a sum over rows and is not scaled."""
        share = self._share()
        if share == 1.0:
            return loss, log
        return loss * share, {k: v * share for k, v in log.items()}

    def _rows_loss_and_grads(self, ent_rows, rel_rows, proj_rows, impts, *,
                             b: int, num_chunks: int, chunk_size: int,
                             neg_sample_size: int, neg_head: bool):
        """Loss + gradients w.r.t. already-gathered fp32 rows.  Returns
        (loss, log, (ent_grads, rel_grads, proj_grads or None)); log values
        are detached.

        Where _transe_l2_fused holds, ops/transe_l2.py computes them in
        one fused pass (two kernels on the card); every other case runs
        autograd over the score function and the loss.

        --compute_dtype bfloat16 (the JAX package's cast, ke_model.py:
        289-325): the rows are cast to bf16 before scoring and the scores
        come back as fp32; the loss, the regularization (on the fp32 rows),
        the gradients w.r.t. the fp32 rows and the update stay fp32."""
        cfg = self.config
        chunks = dict(b=b, num_chunks=num_chunks, chunk_size=chunk_size,
                      neg_sample_size=neg_sample_size)
        if self._transe_l2_fused(ent_rows, rel_rows, **chunks):
            reg = cfg.regularization_coef > 0.0 and \
                cfg.regularization_norm > 0
            loss, log, g_ent, g_rel = transe_l2.loss_and_grads(
                ent_rows, rel_rows, impts, **chunks, neg_head=neg_head,
                gamma=self.score_fn.gamma,
                adversarial=self.loss_gen.neg_adversarial_sampling,
                temperature=self.loss_gen.adversarial_temperature,
                share=self._share(),
                reg_coef=cfg.regularization_coef if reg else 0.0,
                reg_pow=cfg.regularization_norm if reg else 0)
            return loss, log, (g_ent, g_rel, None)
        leaves = [x.detach().requires_grad_() for x in
                  ([ent_rows, rel_rows] if proj_rows is None
                   else [ent_rows, rel_rows, proj_rows])]
        ent_rows, rel_rows = leaves[:2]
        bf16 = cfg.compute_dtype == "bfloat16"

        def scores(ent_rows, rel_rows, *proj):
            if bf16:
                ent_rows, rel_rows = (x.to(torch.bfloat16)
                                      for x in (ent_rows, rel_rows))
                proj = tuple(x.to(torch.bfloat16) for x in proj)
            pos, negs, _ = self._pos_neg_scores(
                (ent_rows[:b], ent_rows[b:2 * b]), rel_rows,
                ent_rows[2 * b:], proj[0] if proj else None,
                neg_head=neg_head, num_chunks=num_chunks,
                chunk_size=chunk_size, neg_sample_size=neg_sample_size,
                neg_deg_sample=cfg.neg_deg_sample)
            return pos.float(), negs.float()

        with torch.enable_grad():
            if self.score_fn.name == "RotatE":
                # recompute the [C, Bc, K, D/2] residuals in backward
                # instead of keeping them (the JAX package's jax.checkpoint)
                pos, negs = checkpoint(scores, *leaves, use_reentrant=False)
            else:
                pos, negs = scores(*leaves)
            loss, log = self._batch_share(
                *self.loss_gen.get_total_loss(pos, negs, impts))
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

    def _rescal_loss_and_grads_factored(self, ent_rows, rel_rows,
                                        rel_pow_sum, tmp0, impts, *,
                                        b: int, num_chunks: int,
                                        chunk_size: int, neg_sample_size: int,
                                        neg_head: bool):
        """RESCAL loss and gradients with the relation gradient kept as
        rank-1 factors (JAX: _rescal_loss_and_grads_factored).

        Tail-corrupt: tmp = R^T h gives pos = tmp.t and negs = tmp.n;
        head-corrupt: tmp = R t gives pos = h.tmp and negs = n.tmp.
        ``tmp0``, that tmp, comes with the relation rows
        (gather_rows_matvec).
        Differentiating w.r.t. tmp instead of the relation rows makes each
        edge's relation gradient an outer product, which the outer-product
        Adagrad kernel applies without forming the [B, Dr*De] array.  It
        also applies the relation rows' regularization gradient; only the
        value enters here, for the loss and the log: ``rel_pow_sum``, the
        sum of |x|^p over the gathered relation rows (gather_rows_matvec),
        None without regularization."""
        cfg = self.config
        sf = self.score_fn
        rmat = rel_rows.reshape(b, sf.relation_dim, sf.entity_dim)
        h0, t0 = ent_rows[:b], ent_rows[b:2 * b]
        ent_rows = ent_rows.detach().requires_grad_()
        tmp = tmp0.detach().requires_grad_()
        reg_on = rel_pow_sum is not None
        with torch.enable_grad():
            side = ent_rows[:b] if neg_head else ent_rows[b:2 * b]
            pos = torch.sum(side * tmp, dim=-1)
            negs = torch.matmul(
                tmp.reshape(num_chunks, chunk_size, -1),
                ent_rows[2 * b:].reshape(num_chunks, neg_sample_size,
                                         -1).transpose(1, 2))
            loss, log = self._batch_share(*self.loss_gen.get_total_loss(
                pos, negs.reshape(-1, neg_sample_size), impts))
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
            reg_rel = cfg.regularization_coef * rel_pow_sum
            log["regularization"] = log["regularization"] + reg_rel
            loss = loss + reg_rel
        log = {k: v.detach() for k, v in log.items()}
        return loss.detach(), log, (g_ent, ("outer",) + factors, None)

    # -- train step ----------------------------------------------------------

    def train_step(self, state: TrainState, h, r, t, neg, impts, *,
                   neg_head: bool):
        """One full step, IN PLACE on ``state`` (a TrainState or host
        tables).  Returns (state, log)."""
        _, log, (ent_ids, ent_grads, rel_grads, proj_grads), rows = \
            self._grads_and_rows(state, h, r, t, neg, impts,
                                 neg_head=neg_head)
        ent_rows, rel_rows, proj_rows = rows or (None, None, None)
        self._update_entity(state, ent_ids, ent_grads, rows=ent_rows)
        self._update_relation(state, r, rel_grads, proj_grads,
                              rows=(rel_rows, proj_rows))
        state.step += 1
        return state, log

    def train_step_async(self, state: TrainState, pending, h, r, t, neg,
                         impts, *, neg_head: bool):
        """A step with the entity update deferred (--async_update), IN
        PLACE on ``state``: the previous step's entity update (``pending``,
        (ids, grads) or None) is applied after this step's gather, so the
        rows it scores are one step stale; relations (and TransR's
        projections) update at once.  Returns (state, this step's entity
        update as the new pending, log); ``flush_async`` applies the last
        one.  Not for host tables, whose updates start from the rows
        gathered in their own step."""
        _, log, (ent_ids, ent_grads, rel_grads, proj_grads) = \
            self.loss_and_grads(state, h, r, t, neg, impts,
                                neg_head=neg_head)
        self.flush_async(state, pending)
        self._update_relation(state, r, rel_grads, proj_grads)
        state.step += 1
        return state, (ent_ids, ent_grads), log

    def flush_async(self, state: TrainState, pending) -> TrainState:
        """Apply a pending entity update; None launches nothing."""
        if pending is not None:
            self._update_entity(state, pending[0], pending[1])
        return state

    def _update_entity(self, state: TrainState, ids, grads, *,
                       rows=None) -> None:
        """The entity update of a step: K2 on this device's table (from
        ``rows``, the entity rows of the step, on host tables), or through
        the plan (to the owners' shards along the gather's Route, or
        all-gathered onto every replica)."""
        lr = self.config.lr
        if self.plan is None:
            sparse_adagrad_update(state.entity, ids, grads, lr, rows)
        elif self.plan.vocab:
            self.plan.routed_update(state.entity, ids, grads, lr)
        else:
            self.plan.allgather_update(state.entity, ids, grads, lr)

    def _update_relation(self, state: TrainState, r, rel_grads,
                         proj_grads, *, rows=(None, None)) -> None:
        """The relation update of a step (the outer-product kernel on
        RESCAL's factored route) and TransR's projection update; on host
        tables each K2 starts from ``rows``, the step's relation and
        projection rows.  Under a plan every rank's (ids, gradients) are
        all-gathered first, in rank order, and each replica applies them
        all."""
        cfg = self.config
        if self.plan is not None:
            gather = self.plan.allgather
            r = gather(r)
            rel_grads = (rel_grads[:1] + tuple(gather(x) for x in
                                               rel_grads[1:])
                         if isinstance(rel_grads, tuple)
                         else gather(rel_grads))
            proj_grads = None if proj_grads is None else gather(proj_grads)
        if isinstance(rel_grads, tuple) and rel_grads[0] == "outer":
            outer_adagrad_update(state.relation, r, rel_grads[1],
                                 rel_grads[2], cfg.lr,
                                 reg_coef=cfg.regularization_coef,
                                 reg_norm=cfg.regularization_norm)
        else:
            sparse_adagrad_update(state.relation, r, rel_grads, cfg.lr,
                                  rows[0])
        if self.is_transr:
            sparse_adagrad_update(state.projection, r, proj_grads, cfg.lr,
                                  rows[1])

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
        nonzero for real entries.  Blocked over the entity axis.  On a
        vocab-sharded table, eval_ranks_sharded."""
        if self.plan is not None and self.plan.vocab:
            return self.eval_ranks_sharded(state, h, r, t, filter_ids,
                                           filter_mask, neg_head=neg_head,
                                           block=block)
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

    @torch.no_grad()
    def eval_group_ranks(self, state: TrainState, h, r, t, filter_ids,
                         filter_mask, *, neg_head: bool) -> torch.Tensor:
        """Ranks [g, B] of a group of g batches (h, r, t [g, B]; filter
        lists [g, B, F]) as ONE flattened [g*B] batch of eval_ranks (the
        JAX package's _eval_group_ranks): every candidate block streams
        past the whole group once, and its block width is
        _eval_block_size(g*B).  Ranking is per row, so the flattening is
        exact."""
        g, b = h.shape
        f = filter_ids.shape[-1]
        return self.eval_ranks(
            state, h.reshape(g * b), r.reshape(g * b), t.reshape(g * b),
            filter_ids.reshape(g * b, f), filter_mask.reshape(g * b, f),
            neg_head=neg_head).reshape(g, b)

    @torch.no_grad()
    def eval_ranks_sharded(self, state: TrainState, h, r, t, filter_ids,
                           filter_mask, *, neg_head: bool,
                           block: Optional[int] = None) -> torch.Tensor:
        """eval_ranks on a vocab-sharded entity table (JAX:
        _sharded_eval_group_fn): every rank holds the same batch, gathers
        its positive side through the plan's routed gather, scores ITS OWN
        rows in contiguous blocks and counts the scores that reach each
        positive (padded rows and the tail block's re-covered rows masked),
        minus the filter hits on its shard; one all-reduce of the [B]
        counts gives ranks identical to one device's.  Only the counts
        cross ranks."""
        plan = self.plan
        b = h.shape[0]
        pos, side, rel_rows, proj_rows = self._eval_pos_side(
            state, h, r, t, neg_head=neg_head)
        per, offset = plan.per, plan.lo
        block = min(block or self._eval_block_size(b), per)
        dev = pos.device
        counts = torch.zeros(b, dtype=torch.int64, device=dev)
        lrow = filter_ids.to(torch.int64) - offset   # filter row on the shard
        for start in range(0, per, block):
            cs = min(start, per - block)
            cand = state.entity.emb[cs:cs + block, :self.entity_dim].float()
            gids = cs + torch.arange(block, device=dev)
            valid = (gids >= start) & (offset + gids < self.n_entities)
            local = lrow - cs
            in_blk = (lrow >= start) & (local < block) & (filter_mask > 0)
            counts += self._block_ge_counts(pos, side, rel_rows, proj_rows,
                                            cand, valid, local, in_blk,
                                            neg_head=neg_head)
        counts = plan.allreduce_counts(counts)
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
        if self.plan is not None and self.plan.vocab:
            # one routed gather for both sides
            ht = self._gather_entity(state, torch.cat([h, t]))[0]
            h_rows, t_rows = ht[:h.shape[0]], ht[h.shape[0]:]
        else:
            h_rows = gather_rows(state.entity, h, self.entity_dim)
            t_rows = gather_rows(state.entity, t, self.entity_dim)
        rel_rows = gather_rows(state.relation, r, self.relation_dim)
        proj_rows = (gather_rows(state.projection, r, self.proj_dim)
                     if self.is_transr else None)
        pos, side = self._rows_pos_side(h_rows, t_rows, rel_rows, proj_rows,
                                        neg_head=neg_head)
        return pos, side, rel_rows, proj_rows

    def _rows_pos_side(self, h_rows, t_rows, rel_rows, proj_rows, *,
                       neg_head: bool):
        """Row-level core of _eval_pos_side on gathered fp32 rows: (pos
        [B], side rows [B, D], TransR's projected)."""
        sf = self.score_fn
        if self.is_transr:
            h_rows = sf.project(h_rows, proj_rows)
            t_rows = sf.project(t_rows, proj_rows)
        pos = sf.pos_score(h_rows, rel_rows, t_rows)
        return pos, (t_rows if neg_head else h_rows)

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

    @torch.no_grad()
    def eval_ranks_sampled(self, state: TrainState, h, r, t, neg,
                           neg_keep=None, *, neg_head: bool,
                           neg_deg_sample: bool = False,
                           n_valid=None) -> torch.Tensor:
        """Ranks against K sampled negatives shared by a batch (the
        reference's --neg_sample_size_eval protocol): rank_i = 1 + |{j
        kept : score_i(neg_j) >= pos_i}|.

        One batch (h, r, t [B]; neg [K]; neg_keep [B, K]; n_valid an int)
        or a group of G batches ranked together (h, r, t [G, B]; neg
        [G, K]; neg_keep [G, B, K]; n_valid [G]), each row's rank the same
        either way.  neg_keep None keeps every candidate.  Two gathers
        (three for TransR): the entity rows [h | t | neg] and the
        relation rows."""
        n = h.numel()
        ids = torch.cat([h.reshape(-1), t.reshape(-1), neg.reshape(-1)])
        ent = self._gather_entity(state, ids)[0]
        rel_rows = gather_rows(state.relation, r.reshape(-1),
                               self.relation_dim)
        proj_rows = (gather_rows(state.projection, r.reshape(-1),
                                 self.proj_dim) if self.is_transr else None)

        def rows(x):   # [(G,) rows, D], as the ids came
            return x.reshape(*h.shape[:-1], -1, x.shape[-1])

        return self._rows_eval_ranks_sampled(
            rows(ent[:n]), rows(ent[n:2 * n]), rows(rel_rows),
            None if proj_rows is None else rows(proj_rows),
            rows(ent[2 * n:]), neg_keep, neg_head=neg_head,
            neg_deg_sample=neg_deg_sample, n_valid=n_valid)

    def _rows_eval_ranks_sampled(self, h_rows, t_rows, rel_rows, proj_rows,
                                 neg_rows, neg_keep=None, *, neg_head: bool,
                                 neg_deg_sample: bool = False,
                                 n_valid=None) -> torch.Tensor:
        """Row-level core of eval_ranks_sampled on fp32 rows: h_rows,
        t_rows [(G,) B, De], rel_rows [(G,) B, Dr], TransR's proj_rows
        [(G,) B, De*Dr] or None, neg_rows [(G,) K, De]; ranks [(G,) B].

        neg_deg_sample keeps the reference's quirk: each batch's own
        corrupted-side entities are PREPENDED as candidates and the
        self-match diagonal is multiplied by zero, not excluded, so it
        still takes part in the >= pos test.  The own-node columns of
        padded rows (j >= n_valid) are masked."""
        sf = self.score_fn
        one = h_rows.dim() == 2
        if one:
            h_rows, t_rows, rel_rows, neg_rows = (
                x[None] for x in (h_rows, t_rows, rel_rows, neg_rows))
            proj_rows = None if proj_rows is None else proj_rows[None]
            neg_keep = None if neg_keep is None else neg_keep[None]
            n_valid = None if n_valid is None else [n_valid]
        g, b = h_rows.shape[:2]
        k = neg_rows.shape[1]
        flat = lambda x: x.reshape(g * b, x.shape[-1])  # noqa: E731
        h_use, t_use, rel = flat(h_rows), flat(t_rows), flat(rel_rows)
        proj = None if proj_rows is None else flat(proj_rows)
        if self.is_transr:
            h_use = sf.project(h_use, proj)
            t_use = sf.project(t_use, proj)
        pos = sf.pos_score(h_use, rel, t_use).reshape(g, b, 1)
        side = t_use if neg_head else h_use
        if neg_deg_sample:
            own = h_rows if neg_head else t_rows          # raw rows
            neg_rows = torch.cat([own, neg_rows], dim=1)
            k = b + k
        cand = neg_rows.reshape(g * k, -1)
        if self.is_transr:
            # every candidate projected by each row's relation
            cand = sf.neg_project(cand, proj, g)
            side = side.reshape(g, b, -1)
        s = sf.neg_score(side, rel, cand, neg_head=neg_head, num_chunks=g,
                         chunk_size=b, neg_sample_size=k).reshape(g, b, k)
        keep = None if neg_keep is None else neg_keep.to(s.device) > 0
        if neg_deg_sample:
            s = s * (1.0 - torch.eye(b, k, dtype=s.dtype, device=s.device))
            nv = torch.as_tensor(b if n_valid is None else n_valid,
                                 device=s.device).reshape(-1, 1, 1)
            own_keep = (torch.arange(b, device=s.device)[None, None, :]
                        < nv).expand(g, b, b)
            keep = torch.cat([own_keep, torch.ones(
                (g, b, k - b), dtype=torch.bool, device=s.device)
                if keep is None else keep], dim=2)
        hit = s >= pos
        if keep is not None:
            hit = hit & keep
        ranks = torch.sum(hit, dim=2) + 1
        return ranks[0] if one else ranks

    @torch.no_grad()
    def candidate_scores(self, state: TrainState, h, r, cand_ids, *,
                         neg_head: bool = False) -> torch.Tensor:
        """Scores of each row's candidate list, [B, K] fp32 (the
        reference's predict_score_wikikg): h, r [B], cand_ids [B, K].  Two
        gathers (three for TransR): the entity rows [h | candidates] and
        the relation rows.  The tables' rows are upcast to fp32 first, bf16
        tables too (the JAX package scores a bf16 table in bf16)."""
        sf = self.score_fn
        b, k = cand_ids.shape
        ent = self._gather_entity(state, torch.cat(
            [h.reshape(-1).to(torch.int64), cand_ids.reshape(-1).to(
                torch.int64)]))[0]
        h_rows, cand = ent[:b], ent[b:]
        rel_rows = gather_rows(state.relation, r, self.relation_dim)
        if self.is_transr:
            # the query row and its K candidates, each projected by the
            # row's own relation matrix
            proj_rows = gather_rows(state.projection, r, self.proj_dim)
            h_rows = sf.project(h_rows, proj_rows)
            p = proj_rows.reshape(b, self.entity_dim, self.relation_dim)
            cand = torch.einsum("bkd,bdr->bkr",
                                cand.reshape(b, k, self.entity_dim), p)
            s = sf.neg_score(h_rows.reshape(b, 1, -1), rel_rows,
                             cand.reshape(b, 1, k, -1), neg_head=neg_head,
                             num_chunks=b, chunk_size=1, neg_sample_size=k)
            return s.reshape(b, k)
        s = sf.neg_score(h_rows, rel_rows, cand, neg_head=neg_head,
                         num_chunks=b, chunk_size=1, neg_sample_size=k)
        return s.reshape(b, k)

    @torch.no_grad()
    def candidate_eval(self, state: TrainState, query, cand_ids, ans, *,
                       top: bool) -> torch.Tensor:
        """One batch of the candidate protocol (the body of the JAX
        package's make_candidate_megastep): query [B, 2] (h, r), cand_ids
        [B, K], ans [B].  Valid mode (top False): each answer's rank
        [B] (candidate_ranks); Test mode: the top-10 positions [B,
        min(10, K)] (candidate_top); ``ans`` is not read there."""
        scores = self.candidate_scores(state, query[:, 0], query[:, 1],
                                       cand_ids)
        return candidate_top(scores) if top else candidate_ranks(scores,
                                                                 ans)


def candidate_ranks(scores: torch.Tensor, ans: torch.Tensor) -> torch.Tensor:
    """Valid-mode rank of each row's answer among its candidates: the
    answer counts itself, sum(scores >= scores[ans]) + 1, so the best rank
    is 2 (the reference's general_models.py:504)."""
    pos = torch.gather(scores, 1, ans.reshape(-1, 1).long())
    return torch.sum(scores >= pos, dim=1) + 1


def candidate_top(scores: torch.Tensor, top: int = 10) -> torch.Tensor:
    """Test-mode positions of each row's ``top`` best candidates (fewer
    when a row has fewer), tied candidates lowest position first, as
    lax.top_k orders them: a stable descending sort, since torch.topk
    promises no order among ties."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return order[:, :min(top, scores.shape[1])]


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
