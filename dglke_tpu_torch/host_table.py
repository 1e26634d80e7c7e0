"""Host-resident embedding tables (--mix_cpu_gpu): train and evaluate
tables larger than the card (counterpart of dglke_tpu/host_table.py, the
reference's CPU ExternalEmbedding mode, train.py:46-49).

The semantics are the JAX package's:

  * the tables live in host memory (fp32, whatever emb_dtype says), drawn
    with numpy from the seed exactly as the JAX package draws them, so a
    run starts from the same tables bit for bit;
  * only a batch's rows move: each step is KEModel.train_step on the
    HostState, which gathers the [h | t | neg] entity rows and the
    relation rows (and TransR's projection rows), computes the loss and
    the row gradients (RESCAL by the plain row route), and writes each
    table back by row-sparse Adagrad with the JAX ordering (every
    occurrence's mean(g^2) into state_sum first, then the std);
  * full-entity eval streams the entity table through the device once, in
    contiguous blocks, each scored against both corruption directions;
  * checkpoints are the standard npy contract, so host-mode and device
    checkpoints interchange, across both packages.

What differs is who moves the rows.  The JAX package gathers them with
numpy, uploads them, downloads the gradients and applies np.add.at on the
host.  Here, on the card, the tables are pinned in place and mapped into
the card's address space (ops/rows.py:map_host), and the step's kernels
work on them there: K1 (gather_rows) reads the rows over the host link
into rows on the card, K2 (sparse_adagrad_rows) updates each touched row
from those rows and writes it and its state back once.  Only the touched
rows cross the link, each once a way, and the host does no table work.  On the CPU (device="cpu") the same code takes
the kernels' plain versions.

Each training step is one fed call (models/fed_step.py, host_fed_step):
a trainer.HostFeed samples and packs the batches ahead, the call copies a
batch's ids into its static inputs on the model's device, and on a card
replays a CUDA graph of the step, whose K1 and K2 reach the mapped tables;
on the CPU it runs the step eagerly.  host_step is the same step eagerly,
with its batch uploaded.

The eval makes the model's eval calls (models/eval_step.py), as the JAX
package calls its three jits: the sampled groups through the device
path's sampled call, the full-entity eval through host_pos_side (one
call a direction) and host_block_counts (one call a streamed block,
every direction and query chunk in it).  On a card each is a CUDA graph
a memo key, replayed, K1 reading the mapped tables inside it; the
block's rows reach it through a staging buffer that a copy-engine copy
fills under the previous block's call.

K2 writes the mapped tables asynchronously on the current stream: every
host-side read of a host table first waits for the card
(ops/rows.py:sync_mapped), as utils/io.py:save_model does.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch

from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.sampler import EvalSampler, FilterIndex
from dglke_tpu_torch.models.fed_step import FedStep, pack_batch, unpack_batch
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.ops import rows
from dglke_tpu_torch.ops.embedding import gather_rows
from dglke_tpu_torch.trainer import HostFeed, ProfileWindow, steps_per_group


# Host eval query-chunking knobs (see evaluate_host_with_samplers): bound
# the [Q, block] score matrix of one call without losing the one-table-pass
# property.  Module-level so tests can force tiny chunks.
_Q_CAP_BYTES = 256 << 20
_Q_MIN_CHUNK = 1024


@dataclasses.dataclass
class HostEmbedding:
    """Mirror of ops.embedding.EmbeddingState over host memory (duck-typed:
    gather_rows, sparse_adagrad_update and utils.io.save_model take it as
    they take a table on the card)."""
    emb: torch.Tensor          # [num, dim] fp32, CPU, numpy-backed
    state_sum: torch.Tensor    # [num] fp32, CPU, numpy-backed


@dataclasses.dataclass
class HostState:
    entity: HostEmbedding
    relation: HostEmbedding
    projection: Optional[HostEmbedding]
    step: int = 0
    is_host = True             # trainer.evaluate dispatch marker


def _host_embedding(emb: np.ndarray, state_sum: np.ndarray,
                    device: torch.device) -> HostEmbedding:
    """Host tables as CPU tensors sharing the arrays' memory; for a model
    on the card, pinned in place and mapped for its kernels."""
    if device.type == "cuda":
        return HostEmbedding(rows.map_host(emb), rows.map_host(state_sum))
    return HostEmbedding(torch.from_numpy(emb), torch.from_numpy(state_sum))


def _init_table(rng: np.random.Generator, num: int, dim: int,
                emb_init: float) -> np.ndarray:
    # float32-native generation, filled in row chunks of 64 MB: rng.uniform
    # would materialize a float64 intermediate, twice the table.  The same
    # draws and arithmetic as the JAX package's _init_table, written in
    # place, so the bits are the same.  The table lies in memory aligned to
    # 2 MB, advised for huge pages before the draw touches it
    # (ops/rows.py:host_zeros).
    emb = rows.host_zeros((num, dim))
    step = max(1, (64 << 20) // max(dim * 4, 1))
    for a in range(0, num, step):
        blk = emb[a:min(a + step, num)]
        rng.random(out=blk, dtype=np.float32)
        blk *= 2.0 * emb_init
        blk -= emb_init
    return emb


def init_host_state(model: KEModel, seed: int = 0, log=None) -> HostState:
    """Uniform(-emb_init, emb_init) init, zero Adagrad state (reference
    tensor_models.py:240-248), drawn with numpy's default_rng(seed) as the
    JAX package draws it: entity, relation, then TransR's projection
    (range 1.0).  With ``log``, one line of the seconds the draw and the
    mapping took."""
    rng = np.random.default_rng(seed)
    cfg = model.config
    t0 = time.time()
    arrays = [_init_table(rng, model.n_entities, model.entity_dim,
                          cfg.emb_init),
              _init_table(rng, model.n_relations, model.relation_dim,
                          cfg.emb_init)]
    if model.is_transr:
        arrays.append(_init_table(rng, model.n_relations, model.proj_dim,
                                  1.0))
    t1 = time.time()
    states = [rows.host_zeros((a.shape[0],)) for a in arrays]
    tables = [_host_embedding(a, ss, model.device)
              for a, ss in zip(arrays, states)]
    if log is not None:
        n_bytes = sum(a.nbytes + 4 * a.shape[0] for a in arrays)
        where = (f"pinned and mapped for {model.device}"
                 if model.device.type == "cuda" else "wrapped on the CPU")
        log(f"[proc 0]host tables: {n_bytes} bytes drawn in "
            f"{t1 - t0:.3f} s; {where} in {time.time() - t1:.3f} s; "
            f"{rows.host_pages(arrays + states)}")
    return HostState(tables[0], tables[1],
                     tables[2] if model.is_transr else None, 0)


def load_host_state(config: KGEConfig, model: KEModel,
                    path: str) -> HostState:
    """Restore a HostState straight from the npy artifacts, with no copy
    through the card (loading the table onto the card is what host mode
    exists to avoid).  Artifact naming lives in one place:
    utils.io.table_artifact_arrays."""
    from dglke_tpu_torch.utils.io import saved_step, table_artifact_arrays

    def host_copy(a: np.ndarray) -> np.ndarray:
        out = rows.host_zeros(a.shape)
        out[...] = a
        return out

    def load(name):
        # read through a mapping of the files, straight into the tables'
        # own memory (ops/rows.py:host_zeros)
        emb, ss = table_artifact_arrays(config, path, name, mmap_mode="r")
        return _host_embedding(host_copy(emb), host_copy(ss), model.device)

    return HostState(load("entity"), load("relation"),
                     load("projection") if model.is_transr else None,
                     saved_step(config, path))


def host_step(model: KEModel, state: HostState, batch: dict):
    """One eager training step on host tables of a TrainSampler batch: its
    ids packed (pack_batch) and moved to the model's device in one
    transfer, its edge weights in another, then KEModel.train_step.
    Returns the step's log dict."""
    packed, impts, neg_head, b = pack_batch(batch, pin=False)
    dev = model.device
    return model.train_step(
        state, *unpack_batch(packed.to(dev), b),
        None if impts is None else impts.to(dev), neg_head=neg_head)[1]


def host_fed_step(model: KEModel) -> FedStep:
    """The host-table step as a fed call, one step a call: on a card one
    CUDA graph a memo key, replayed (models/fed_step.py)."""
    return FedStep(model, 1)


def train_host(config: KGEConfig, dataset, model: Optional[KEModel] = None,
               state: Optional[HostState] = None, valid_samplers=None,
               save_fn=None, log=print, device=None,
               profile_dir: Optional[str] = None):
    """Host-table training loop (the reference's mix_cpu_gpu trainer,
    train_pytorch.py:268-403 with CPU-resident ExternalEmbedding): one
    TrainSampler batch a step, from a trainer.HostFeed, through the fed
    step (host_fed_step), as the JAX package calls its jitted row step
    once a step.  Returns (model, state, stats) like trainer.train.
    --async_update has no effect here, as in the JAX package.
    ``profile_dir`` (--profile, which the JAX package's host mode drops): a
    trainer.ProfileWindow trace over steps [2s, 4s), s the step group the
    device loop would take; each replayed step is one span."""
    cfg = config
    if model is None:
        model = KEModel(cfg, dataset.n_entities, dataset.n_relations,
                        device=device)
    if state is None:
        state = init_host_state(model, cfg.seed, log=log)
    fused = host_fed_step(model)
    log("[proc 0]host tables: " + ("one CUDA graph a step" if fused.on_graphs
                                   else "each step eagerly on the CPU"))
    feed = HostFeed(model, dataset, cfg.batch_size, cfg.neg_sample_size,
                    seed=cfg.seed)

    window = ProfileWindow(profile_dir, steps_per_group(
        cfg, dataset.n_train, False, log=lambda *a: None), model.device, log)
    logs = []
    valid_metrics = None
    start = tic = time.time()
    sample_time = update_time = 0.0
    try:
        for step in range(1, cfg.max_step + 1):
            window.before(step - 1)
            t0 = time.time()
            batches = feed.take(1)
            t1 = time.time()
            _, log_dict = fused(state, batches, step - 1, window.span)
            logs.append(log_dict)
            sample_time += t1 - t0
            update_time += time.time() - t1

            if step % cfg.log_interval == 0:
                for k in logs[0]:
                    v = torch.cat([la[k] for la in logs]).mean().item()
                    log(f"[proc 0][Train]({step}/{cfg.max_step}) "
                        f"average {k}: {v}")
                logs = []
                log(f"[proc 0][Train] {cfg.log_interval} steps take "
                    f"{time.time() - tic:.3f} seconds")
                log(f"[proc 0]sample: {sample_time:.3f}, update: "
                    f"{update_time:.3f}")
                tic = time.time()
                sample_time = update_time = 0.0
            window.after(step)
            if (valid_samplers is not None and cfg.valid
                    and step % cfg.eval_interval == 0):
                valid_metrics = evaluate_host_with_samplers(
                    model, state, valid_samplers, phase="Valid", log=log)
            if save_fn is not None and cfg.save_interval > 0 \
                    and step % cfg.save_interval == 0:
                save_fn(state, step)
        window.stop()
    finally:
        feed.close()

    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    total = time.time() - start
    if fused.on_graphs:
        log(f"[proc 0]CUDA graphs: {len(fused.graphs)} captured, "
            f"{fused.replays} replays")
    log(f"[proc 0]training takes {total} seconds")
    stats = {"train_time": total}
    if valid_metrics is not None:
        stats["valid_metrics"] = valid_metrics
    return model, state, stats


def evaluate_host(config: KGEConfig, dataset, model: KEModel,
                  state: HostState, split: str = "test",
                  filter_index: Optional[FilterIndex] = None,
                  log=print, phase: str = "Test") -> Dict[str, float]:
    """trainer.evaluate for host tables: both corrupt modes of ``split``,
    against every entity or sampled negatives, filtered or raw."""
    cfg = config
    if cfg.eval_filter and filter_index is None:
        filter_index = FilterIndex(dataset)
    samplers = [
        EvalSampler(dataset, split, cfg.batch_size_eval, mode,
                    filter_index if cfg.eval_filter else None,
                    eval_percent=cfg.eval_percent, seed=cfg.seed,
                    neg_sample_size=cfg.neg_sample_size_eval,
                    neg_deg_sample=cfg.neg_deg_sample_eval)
        for mode in ("head", "tail")
    ]
    return evaluate_host_with_samplers(model, state, samplers, phase=phase,
                                       log=log)


def host_pos_side(model: KEModel, state: HostState, ids, *,
                  neg_head: bool) -> tuple:
    """The pos/side preamble of one direction's queries (the JAX package's
    _host_pos_side_fn, the group function of EvalCalls.host_pos_side):
    ids [h | t | r] int32 on the model's device; K1 gathers the [h | t]
    entity rows, the relation rows (and TransR's projection rows) from the
    host tables, then KEModel._rows_pos_side.  Returns (pos [n], side rows
    [n, D] (TransR's projected), rel rows, TransR's proj rows or None)."""
    n = ids.shape[0] // 3
    ent = gather_rows(state.entity, ids[:2 * n], model.entity_dim)
    rel = gather_rows(state.relation, ids[2 * n:], model.relation_dim)
    proj = (gather_rows(state.projection, ids[2 * n:], model.proj_dim)
            if model.is_transr else None)
    pos, side = model._rows_pos_side(ent[:n], ent[n:], rel, proj,
                                     neg_head=neg_head)
    return pos, side, rel, proj


def host_block_counts(model: KEModel, cand, cs, start_row, dirs,
                      q_cap: int) -> None:
    """One candidate block against every query chunk of every direction
    (the JAX package's _host_block_counts_fn with its loop body, the group
    function of EvalCalls.host_block): ``cand`` holds the entity rows
    [cs, cs + block), of which rows from ``start_row`` on are counted
    (the tail block starts early, so that every block has one shape).
    ``cs`` and ``start_row`` are ints or 0-d int64 tensors on cand's
    device: inside a CUDA graph the tensors, written before each replay,
    give each block its own place.  Each direction (a HostBlocks dict) has
    KEModel._block_ge_counts of each chunk of at most ``q_cap`` query rows
    added into its counts."""
    block = cand.shape[0]
    gids = cs + torch.arange(block, device=cand.device)
    valid = (gids >= start_row) & (gids < model.n_entities)
    for d in dirs:
        local = d["fid"] - cs
        in_blk = (d["fid"] >= start_row) & (local < block) & (d["fm"] > 0)
        n_pad = len(d["counts"])
        q = min(n_pad, q_cap)
        for q0 in range(0, n_pad, q):
            sl = slice(q0, q0 + q)
            d["counts"][sl] += model._block_ge_counts(
                d["pos"][sl], d["side"][sl], d["rel"][sl],
                None if d["proj"] is None else d["proj"][sl], cand, valid,
                local[sl], in_blk[sl], neg_head=d["neg_head"])


def _queries(sampler) -> Optional[dict]:
    """One direction's queries, all its batches in one: h, r, t, the real
    rows (nv), and the filter lists padded to the widest (fid, fm; eight
    zero columns unfiltered).  None for an empty sampler."""
    batches = list(sampler)
    if not batches:
        return None
    h, r, t = (np.concatenate([ba[k] for ba in batches])
               for k in ("h", "r", "t"))
    nv = np.concatenate([
        np.arange(len(ba["h"])) < ba["n_valid"] for ba in batches])
    fmax = (max(ba["filter_ids"].shape[1] for ba in batches)
            if "filter_ids" in batches[0] else 8)
    fid = np.zeros((len(h), fmax), np.int32)
    fm = np.zeros((len(h), fmax), np.uint8)
    if "filter_ids" in batches[0]:
        o = 0
        for ba in batches:
            n, w = ba["filter_ids"].shape
            fid[o:o + n, :w] = ba["filter_ids"]
            fm[o:o + n, :w] = ba["filter_mask"]
            o += n
    return dict(neg_head=batches[0]["neg_head"], h=h, r=r, t=t, nv=nv,
                fid=torch.from_numpy(fid), fm=torch.from_numpy(fm))


def _stream_blocks(model: KEModel, state: HostState, calls, hb, block: int,
                   q_cap: int) -> None:
    """Stream the entity table through the model's device once, one block
    call a block (calls.host_block).  Each block is first copied into one
    of two staging buffers, in turn; on a card by the copy engine on
    calls.copy_stream, from the mapped table, so that block i + 1's copy
    runs under block i's call.  Events order it: the copy stream first
    waits for the current stream (the training's last K2 writes the
    table), a buffer is refilled only after the call that read it, and a
    call waits for its buffer's copy."""
    n_ent = model.n_entities
    src = state.entity.emb
    card = model.device.type == "cuda"
    if card and rows.mapped_address(src) is None:
        raise ValueError("host eval: the entity table is not mapped for "
                         f"{model.device} (rows.map_host)")
    bufs = calls.host_buffers(block, src.shape[1])
    starts = range(0, n_ent, block)
    if card:
        main = torch.cuda.current_stream(model.device)
        copier = calls.copy_stream
        copier.wait_stream(main)
        filled = [torch.cuda.Event() for _ in bufs]
        freed = [torch.cuda.Event() for _ in bufs]

    def stage(i):
        j = i % 2
        cs = min(starts[i], n_ent - block)
        if not card:
            bufs[j].copy_(src[cs:cs + block])
            return
        with torch.cuda.stream(copier):
            if i >= 2:
                copier.wait_event(freed[j])
            bufs[j].copy_(src[cs:cs + block], non_blocking=True)
            filled[j].record(copier)

    stage(0)
    for i, start_row in enumerate(starts):
        j = i % 2
        if i + 1 < len(starts):
            stage(i + 1)
        if card:
            main.wait_event(filled[j])
        hb.cs.fill_(min(start_row, n_ent - block))
        hb.start.fill_(start_row)
        calls.host_block(state, hb, j, partial(
            host_block_counts, model, bufs[j], hb.cs, hb.start, hb.dirs,
            q_cap))
        if card:
            freed[j].record(main)


@torch.no_grad()
def evaluate_host_with_samplers(model: KEModel, state: HostState,
                                samplers, phase: str = "Test",
                                log=print) -> Dict[str, float]:
    """Full-entity ranking with the table streamed from host memory.

    All query batches of both directions are collected first; their
    pos/side rows come from one host_pos_side call a direction (K1 gathers
    from the host tables).  The entity table then crosses the host link
    once, in contiguous blocks of one shape, each block scored against
    every query row of both directions by one host_block_counts call
    (KEModel._block_ge_counts, the device path's tie-exact count).  The
    query axis is cut into chunks of at most _Q_CAP_BYTES of scores,
    padded to a multiple of the chunk.  The calls are the model's
    eval_calls: on a card CUDA graphs, memoized across evals (a --valid
    eval of one split reuses its graphs every interval)."""
    from dglke_tpu_torch.trainer import (CandidateEvalSampler, _log_graphs,
                                         combine_rank_metrics,
                                         evaluate_with_samplers)

    if any(isinstance(s, CandidateEvalSampler) for s in samplers):
        raise NotImplementedError(
            "host-table mode evaluates with the full-entity protocol; "
            "candidate-list (wikikg90M-style) eval needs the table on "
            "device — drop --mix_cpu_gpu for eval (checkpoints "
            "interchange) or evaluate on a vocab-sharded mesh")
    if any(getattr(s, "neg_sample_size", 0) > 0 for s in samplers):
        # Sampled negatives (--neg_sample_size_eval, the protocol of the
        # reference's Freebase-scale recipes): the device path's grouped
        # calls (the JAX package's _host_sampled_ranks_fn a batch), whose
        # eval_ranks_sampled gathers each group's [h | t | neg] entity rows
        # and relation rows from the host tables with K1 and ranks them
        # with _rows_eval_ranks_sampled.  Only the K candidates and the
        # batch rows cross the link.
        return evaluate_with_samplers(model, state, samplers, phase=phase,
                                      log=log)
    start = time.time()
    dev = model.device
    calls = model.eval_calls
    graphs = (calls.captured, calls.replays)
    queries = [q for q in map(_queries, samplers) if q is not None]
    if not queries:
        raise ValueError("evaluation saw zero edges (empty split or "
                         "eval_percent too small)")
    for q in queries:
        ids = torch.from_numpy(np.concatenate(
            [q["h"], q["t"], q["r"]]).astype(np.int32)).to(dev)
        out = calls.host_pos_side(
            state, partial(host_pos_side, model, state,
                           neg_head=q["neg_head"]), ids,
            neg_head=q["neg_head"], phase=phase)
        # copied out at once: the next eval call may rewrite them
        q.update(zip(("pos", "side", "rel", "proj"),
                     (None if x is None else x.clone() for x in out)))

    block = min(model._eval_block_size(max(len(q["nv"]) for q in queries)),
                model.n_entities)
    # The query axis holds the whole split (collected above so that the
    # table crosses the link once): chunk it so that one call's score
    # matrix stays under _Q_CAP_BYTES.
    q_cap = max(_Q_MIN_CHUNK, _Q_CAP_BYTES // max(block * 4, 1))
    n_pads = [n + ((-n) % q_cap if n > q_cap else 0)
              for n in (len(q["nv"]) for q in queries)]
    hb = calls.host_blocks(state, queries, n_pads, block, q_cap, phase)
    _stream_blocks(model, state, calls, hb, block, q_cap)

    ranks = torch.cat([
        (torch.clamp(d["counts"][:len(q["nv"])], min=0) + 1)[
            torch.from_numpy(q["nv"]).to(dev)]
        for q, d in zip(queries, hb.dirs)])
    metrics = combine_rank_metrics(
        ranks.cpu().numpy(), "evaluation saw zero edges (empty split or "
        "eval_percent too small)")
    for k, v in metrics.items():
        log(f"[0]{phase} average {k}: {v}")
    log(f"[0]{phase} takes {time.time() - start:.3f} seconds")
    _log_graphs(calls, state, graphs, f"[0]{phase}", log)
    return metrics
