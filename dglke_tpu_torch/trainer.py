"""Training and evaluation loops (counterpart of dglke_tpu/trainer.py,
single device).

Training is fed by the device-resident pipeline, or for a dataset smaller
than two batches (and on one device at step group size 1) by the host-fed
TrainSampler, and runs in groups of steps; --async_update defers entity
updates inside each group.  Each group is one fused call
(models/pipeline_step.py on the pipeline, models/fed_step.py on the
host-fed route; on a card, one CUDA graph replayed; under --dist over
NCCL too, over gloo eagerly).
Evaluation ranks against every entity (filtered or raw), against sampled
negatives (--neg_sample_size_eval), or against a candidate list
(wikikg90M), a group of batches a call as the JAX package batches them (on
a card one CUDA graph replayed a call, models/eval_step.py).  The log
format follows the reference ("[proc 0][Train](step/max) average loss:
..." every log_interval; "[0]Test average MRR: ...") so existing tooling
can parse it.  With --mix_cpu_gpu both loops go
to host_table.py, whose tables stay in host memory.

Under a parallel.mesh.ShardingPlan (--dist) every rank runs its own
device pipeline over its own edge partition, ``batch_size`` rows a step
(the global batch is rank 0's rows, then rank 1's, ...), and logs on rank
0 only.  Eval over a vocab-sharded table ranks the same batches on every
rank and gives every rank the global metrics; over replicated tables each
rank ranks its stride of the split and the partial sums are combined.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import queue
import threading
import time
from itertools import chain
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import KGDataset
from dglke_tpu_torch.data.sampler import EvalSampler, FilterIndex, TrainSampler
from dglke_tpu_torch.models.ke_model import (
    KEModel,
    TrainState,
    metrics_from_ranks,
)
from dglke_tpu_torch.models.fed_step import FedStep, pack_batch
from dglke_tpu_torch.models.pipeline_step import DevicePipelineStep

# Domain tags of the two random streams: epoch permutations are seeded from
# (seed, 'perm', epoch) and each step's negatives from (seed, 'negS', step),
# so neither stream can repeat the other (the JAX package's 'negS'
# separation).
_PERM_TAG = 0x7065726D    # 'perm'
_NEG_TAG = 0x6E656753     # 'negS'


def _quiet(*args, **kwargs) -> None:
    pass


def _stream_seed(*words: int) -> int:
    """A 64-bit generator seed hashed from integer words."""
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


class DevicePipeline:
    """Device-resident training feed: the triples and two epoch
    permutations live on the device, and each step samples its batch there.

    The permutations of the current and the next epoch sit in one static
    ring [2, n_edges] (the JAX package's [cur | nxt]): slot epoch % 2 holds
    epoch ``epoch``'s.  Batches may straddle the epoch boundary: positions
    past the end of the current permutation continue into the next
    epoch's, so no tail edge is dropped (exact without-replacement epochs).
    When a step ends in the next epoch, the host regenerates the slot the
    finished epoch freed with the permutation after next.  Negatives are
    uniform ``randint`` draws on the device, each step's from a generator
    seeded from (seed, 'negS', step).  Corruption sides alternate per step,
    head first.  Optional per-edge weights (``impts``) are gathered with
    the batch.

    ``next_batch`` takes one step eagerly.  A group of steps
    (models/pipeline_step.py, the fused call) runs begin_group, the batches
    of group_batches, then end_group; its batches are next_batch's."""

    def __init__(self, model: KEModel, dataset: KGDataset, batch_size: int,
                 neg_total: int, seed: int = 0, rank: int = 0):
        self.device = model.device
        self.n_edges = dataset.n_train
        if self.n_edges < batch_size:
            raise ValueError(f"the device pipeline needs at least one batch "
                             f"of train edges: {self.n_edges} < "
                             f"batch_size {batch_size}")
        self.triples = torch.as_tensor(
            np.stack(dataset.train[:3]).astype(np.int32), device=self.device)
        self.impts = (torch.as_tensor(np.asarray(dataset.train[3],
                                                 np.float32),
                                      device=self.device)
                      if dataset.has_edge_importance else None)
        self.model = model
        self.b = batch_size
        self.neg_total = neg_total
        self.seed = seed
        # a rank's streams are seeded from (seed, rank); rank 0's are the
        # single-device streams
        self.rank_words = (rank,) if rank else ()
        self.neg_gen = torch.Generator(self.device)
        self.gens: list = []    # a group's generators, one a step
        self.ring = torch.empty((2, self.n_edges), dtype=torch.int64,
                                device=self.device)
        self.ring[0] = self._permutation(0)
        self.ring[1] = self._permutation(1)
        # the ring position of a group's first row, [epoch % 2, pos] flat
        self.start = torch.zeros((), dtype=torch.int64, device=self.device)
        self.epoch = 0
        self.pos = 0
        self.step_idx = 0

    def _permutation(self, epoch: int) -> torch.Tensor:
        gen = torch.Generator(self.device)
        gen.manual_seed(_stream_seed(self.seed, _PERM_TAG, epoch,
                                     *self.rank_words))
        return torch.randperm(self.n_edges, generator=gen,
                              device=self.device)

    def _neg_seed(self, step: int) -> int:
        return _stream_seed(self.seed, _NEG_TAG, step, *self.rank_words)

    def _advance(self, steps: int) -> None:
        """Past ``steps`` steps: into the next epoch if they reached it,
        whose successor's permutation then fills the freed slot."""
        self.pos += steps * self.b
        self.step_idx += steps
        if self.pos >= self.n_edges:
            self.pos -= self.n_edges
            self.epoch += 1
            self.ring[(self.epoch + 1) % 2] = self._permutation(
                self.epoch + 1)

    def next_batch(self):
        """(h, r, t, neg, impts or None, neg_head) for the next step."""
        end = self.pos + self.b
        cur = self.ring[self.epoch % 2]
        if end <= self.n_edges:
            idx = cur[self.pos:end]
        else:
            idx = torch.cat([cur[self.pos:],
                             self.ring[(self.epoch + 1) % 2][
                                 :end - self.n_edges]])
        h, r, t = self.triples[:, idx]
        impts = self.impts[idx] if self.impts is not None else None
        self.neg_gen.manual_seed(self._neg_seed(self.step_idx))
        neg = torch.randint(0, self.model.n_entities, (self.neg_total,),
                            generator=self.neg_gen, device=self.device,
                            dtype=torch.int32)
        neg_head = self.step_idx % 2 == 0
        self._advance(1)
        return h, r, t, neg, impts, neg_head

    def begin_group(self, s: int) -> None:
        """Host work before a group of ``s`` steps (at most an epoch): where
        it starts in the ring, and the seeds of its steps' generators."""
        self.start.fill_((self.epoch % 2) * self.n_edges + self.pos)
        while len(self.gens) < s:
            self.gens.append(torch.Generator(self.device))
        for i in range(s):
            self.gens[i].manual_seed(self._neg_seed(self.step_idx + i))

    def group_batches(self, s: int) -> list:
        """The batches of the group begin_group set up, each as next_batch
        gives it, from device tensors only (what a CUDA graph of the group
        records): the group's s x b ring positions run on from ``start``
        and wrap at the ring's end."""
        n, b = self.n_edges, self.b
        flat = torch.remainder(
            self.start + torch.arange(s * b, device=self.device), 2 * n)
        idx = self.ring.view(-1)[flat].view(s, b)
        h, r, t = self.triples[:, idx]
        impts = self.impts[idx] if self.impts is not None else None
        return [(h[i], r[i], t[i],
                 torch.randint(0, self.model.n_entities, (self.neg_total,),
                               generator=self.gens[i], device=self.device,
                               dtype=torch.int32),
                 None if impts is None else impts[i],
                 (self.step_idx + i) % 2 == 0) for i in range(s)]

    def end_group(self, s: int) -> None:
        self._advance(s)

    def run_step(self, state: TrainState):
        h, r, t, neg, impts, neg_head = self.next_batch()
        return self.model.train_step(state, h, r, t, neg, impts,
                                     neg_head=neg_head)


class Prefetcher:
    """Background thread that pulls batches from ``it`` and prepares each
    with ``stage`` ahead of the consumer, double-buffered (the JAX
    package's Prefetcher), so host sampling overlaps device work.  A finite
    stream ends the consumer's iteration; an error on the thread is raised
    in the consumer."""

    _END = object()

    def __init__(self, it: Iterable, stage):
        self._it = iter(it)
        self._stage = stage
        self._q: queue.Queue = queue.Queue(maxsize=2)   # double-buffered
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for batch in self._it:
                staged = self._stage(batch)
                while not self._stop:
                    try:
                        self._q.put(staged, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop:
                    return
            self._q.put(self._END)
        except Exception as e:  # surfaced to the consumer
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


class HostFeed:
    """Host-fed training feed, the JAX package's route for datasets
    smaller than two batches and, on one device, for step group size 1
    (and the feed of host-table mode): one TrainSampler batch a step (its
    numpy stream, a batch wrapping around a partition smaller than itself,
    alternating sides), sampled and packed ahead by a Prefetcher thread
    (pack_batch: pinned for a card), for a FedStep to copy to the
    device."""

    def __init__(self, model: KEModel, dataset: KGDataset, batch_size: int,
                 neg_sample_size: int, seed: int = 0):
        pin = model.device.type == "cuda"
        self.prefetch = Prefetcher(
            TrainSampler(dataset, batch_size, neg_sample_size, seed=seed),
            lambda batch: pack_batch(batch, pin))

    def take(self, s: int) -> list:
        """The next ``s`` batches, as pack_batch packs them."""
        return [next(self.prefetch) for _ in range(s)]

    def close(self):
        self.prefetch.close()


class ProfileWindow:
    """--profile: a torch.profiler trace (CPU and, on a card, CUDA
    activities) over the JAX package's window: started at the first group
    end at step >= 2s, stopped at the first at step >= 4s (or at the end of
    training) once the card is synchronised, so that no kernel is cut off.
    Written as a Chrome/Perfetto JSON trace, ``trace_rank{r}.json`` under
    ``directory``; every rank of a --dist run writes its own, as every
    process of the JAX package does."""

    def __init__(self, directory: Optional[str], s: int, device, log,
                 rank: int = 0):
        self.directory, self.s, self.device, self.log = (directory, s,
                                                         device, log)
        self.path = (None if directory is None
                     else os.path.join(directory, f"trace_rank{rank}.json"))
        self.prof = None
        self.done = False

    def before(self, step: int) -> None:
        if (self.path is not None and self.prof is None and not self.done
                and step >= 2 * self.s):
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()

    def span(self, step: int, last: Optional[int] = None):
        """A ``step N`` span around step N in the trace while it records,
        or a ``steps N-M`` span around the steps N to M of a replayed
        group."""
        if self.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(
            f"step {step}" if last is None else f"steps {step}-{last}")

    def after(self, step: int) -> None:
        if self.prof is not None and step >= 4 * self.s:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        self.done = True
        self.log("[proc 0]profiler trace written")


def steps_per_group(cfg: KGEConfig, n_train: int, device_route: bool,
                    log=print) -> int:
    """Steps a group, s, chosen as the JAX package chooses its fused call
    size (dglke_tpu/trainer.py:193-221): steps_per_call, cut on the device
    route to what the epoch holds, then lowered in steps of two until it
    divides the log, eval and save intervals and max_step (2 or 1 if none
    fits).  The log, eval and save fire at the end of a group; async
    updates flush there."""
    s = cfg.steps_per_call
    if device_route:
        while s > 2 and s * cfg.batch_size > n_train:
            s -= 2
    if s > 1:
        for interval in (cfg.log_interval,
                         cfg.eval_interval if cfg.valid else None,
                         cfg.save_interval if cfg.save_interval > 0
                         else None,
                         cfg.max_step):
            if interval:
                while s > 2 and interval % s != 0:
                    s -= 2
        if cfg.max_step % s != 0 or (s & 1):
            s = 2 if cfg.max_step % 2 == 0 else 1
        for nm, interval in (("log_interval", cfg.log_interval),
                             ("eval_interval",
                              cfg.eval_interval if cfg.valid else None),
                             ("save_interval",
                              cfg.save_interval if cfg.save_interval > 0
                              else None)):
            if interval and s > 1 and interval % s != 0:
                log(f"[proc 0]NOTE: {nm}={interval} is not a multiple of "
                    f"the step group size {s}; it fires at the first "
                    f"step past each multiple of {interval}")
    if cfg.async_update and s == 1:
        log("[proc 0]NOTE: --async_update has no effect at step group "
            "size 1 (the one-step-deferred update only exists inside a "
            "group); training runs fully synchronous")
    return s


def train(config: KGEConfig, dataset: KGDataset,
          model: Optional[KEModel] = None,
          state: Optional[TrainState] = None,
          valid_samplers: Optional[list] = None,
          save_fn=None, log=print, device=None, plan=None,
          profile_dir: Optional[str] = None) -> tuple:
    """Run the training loop for config.max_step steps; returns (model,
    state, stats).  Runs on the card unless ``device="cpu"`` (or a model
    on the CPU) is given.

    A dataset of at least two batches is fed by the device-resident
    pipeline, a smaller one, or on one device a run of step group size 1,
    by the host-fed TrainSampler, as in the JAX package.  Steps run in
    groups of ``steps_per_group``; with --async_update each step's entity
    update is applied after the next step's gather, and the group's last
    one at its end.  The groups are fused
    calls (models/pipeline_step.py on the pipeline, models/fed_step.py on
    the host-fed route): on a card one CUDA graph replayed a group, on the
    CPU the same group eagerly; under a plan the same, the plan's
    collectives inside the graph over NCCL, and over gloo (host-staged,
    which capture cannot hold) each group eagerly.

    ``plan``: this rank's parallel.mesh.ShardingPlan (--dist); ``dataset``
    is then this rank's edge partition, and ``model`` (built with the
    plan when omitted) steps through it.  Every rank takes max_step steps
    of batch_size rows from its own device pipeline, seeded from (seed,
    rank); a partition under one batch is refused, and the host-fed route
    does not run.  The step group is agreed on the smallest partition,
    and is one step where two batches exceed it.

    ``profile_dir`` (--profile): a ProfileWindow trace of steps [2s, 4s)
    is written there."""
    cfg = config
    model = model or KEModel(cfg, dataset.n_entities, dataset.n_relations,
                             device=device, plan=plan)
    if plan is not None and model.plan is not plan:
        raise ValueError("train(plan=...) needs a model built with the "
                         "same plan")
    if cfg.mix_cpu_gpu and plan is not None:
        raise ValueError("--mix_cpu_gpu keeps tables in one host's memory; "
                         "it is incompatible with a ShardingPlan (drop one "
                         "of the two)")
    if cfg.mix_cpu_gpu:
        # host-resident tables (the reference's --mix_cpu_gpu,
        # train.py:46-49): capacity is host memory, and the step's kernels
        # reach the tables over the host link
        from dglke_tpu_torch.host_table import train_host
        return train_host(cfg, dataset, model=model, state=state,
                          valid_samplers=valid_samplers, save_fn=save_fn,
                          log=log, profile_dir=profile_dir)
    n_train = dataset.n_train
    rank = 0
    if plan is not None:
        rank = plan.rank
        if rank != 0:
            log = _quiet   # logs on rank 0 only
        # every rank must agree on the step group: the smallest partition
        n_train = int(plan.comm.all_reduce(torch.tensor(
            [n_train], dtype=torch.int64), op="min")[0])
        if n_train < cfg.batch_size:
            raise ValueError(
                f"--dist: a rank's edge partition holds {n_train} edges, "
                f"under one batch of {cfg.batch_size}; use fewer ranks or "
                f"a smaller batch_size")
    if state is None:
        state = (plan.init_state(model) if plan is not None
                 else model.init_state())
    pipe_ok = plan is not None or n_train >= 2 * cfg.batch_size
    s = steps_per_group(cfg, n_train, pipe_ok, log=log)
    if plan is not None and s * cfg.batch_size > n_train:
        # a group's rows must fit one epoch of the smallest partition
        s = 1
    # on one device the JAX package leaves its pipeline at s = 1 for the
    # host-fed TrainSampler (dglke_tpu/trainer.py:223-248); under a plan
    # the pipeline runs at every s
    device_route = pipe_ok and (s > 1 or plan is not None)
    if device_route:
        feed = DevicePipeline(model, dataset, cfg.batch_size,
                              cfg.num_chunks * cfg.neg_sample_size,
                              seed=cfg.seed, rank=rank)
        fused = DevicePipelineStep(model, feed, s)
        how = ("" if plan is None
               else f", {plan.n} ranks x {cfg.batch_size} rows a step")
        how += (", one CUDA graph" if fused.on_graphs
                else ", each group eagerly on the CPU" if plan is None
                else f", each group eagerly ({plan.comm.backend})")
        log(f"[proc 0]device-resident pipeline: {s} steps a group{how}")
    else:
        feed = HostFeed(model, dataset, cfg.batch_size, cfg.neg_sample_size,
                        seed=cfg.seed)
        fused = FedStep(model, s)
        why = (f"{dataset.n_train} train edges < 2 x batch_size "
               f"{cfg.batch_size}" if not pipe_ok else "step group size 1")
        log(f"[proc 0]host-fed TrainSampler ({why}): {s} steps a group")
    window = ProfileWindow(profile_dir, s, model.device, log, rank)
    logs: list = []
    valid_metrics = None
    start = tic = time.time()
    sample_time = update_time = 0.0   # the host-fed route's phase timers

    def flush_logs(step):
        nonlocal logs, tic
        keys = list(logs[0])
        means = torch.stack([torch.cat([entry[k].reshape(-1)
                                        for entry in logs]).mean()
                             for k in keys])
        if plan is not None:
            # each rank logged its part of the global batch's values
            means = plan.comm.all_reduce(means)
        for k, v in zip(keys, means.tolist()):
            log(f"[proc 0][Train]({step}/{cfg.max_step}) average {k}: {v}")
        logs = []
        log(f"[proc 0][Train] {cfg.log_interval} steps take "
            f"{time.time() - tic:.3f} seconds")
        tic = time.time()

    def crossed(step, prev, interval):
        # [prev, step] crossed a multiple of interval
        return interval and (step // interval) > (prev // interval)

    step = 0
    while step < cfg.max_step:
        window.before(step)
        prev = step
        if not device_route:
            t0 = time.time()
            batches = feed.take(s)
            t1 = time.time()
            state, log_dict = fused(state, batches, step, window.span)
            sample_time += t1 - t0
            update_time += time.time() - t1
            logs.append(log_dict)
        else:
            state, log_dict = fused(state, window.span)
            logs.append(log_dict)
        step += s
        if crossed(step, prev, cfg.log_interval):
            flush_logs(step)
            if not device_route:
                log(f"[proc 0]sample: {sample_time:.3f}, "
                    f"update: {update_time:.3f}")
                sample_time = update_time = 0.0
        window.after(step)
        if (cfg.valid and valid_samplers is not None
                and crossed(step, prev, cfg.eval_interval)):
            valid_metrics = evaluate_with_samplers(
                model, state, valid_samplers, phase="Valid", log=log,
                plan=plan)
        if (save_fn is not None and cfg.save_interval > 0
                and crossed(step, prev, cfg.save_interval)):
            save_fn(state, step)
    window.stop()
    if not device_route:
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


def evaluate(config: KGEConfig, dataset: KGDataset, model: KEModel,
             state: TrainState, split: str = "test",
             filter_index: Optional[FilterIndex] = None,
             log=print, phase: str = "Test", plan=None) -> Dict[str, float]:
    """Filtered (or raw) ranking over both corrupt modes, against every
    entity or, with 0 < neg_sample_size_eval < n_entities, against sampled
    negatives: every eval triple is ranked under head-corruption AND
    tail-corruption, and the metrics average over both.  Host-resident
    tables (a host_table.HostState) take host_table.evaluate_host.

    Under a ``plan``: with a vocab-sharded table every rank ranks the same
    batches (the table axis is what is split) and computes the global
    metrics; with replicated tables each rank ranks its stride of the
    split and combine_rank_metrics adds the ranks' partial sums.  The
    filter must come from the whole train split, never a partition."""
    cfg = config
    if getattr(state, "is_host", False):
        from dglke_tpu_torch.host_table import evaluate_host
        return evaluate_host(cfg, dataset, model, state, split,
                             filter_index=filter_index, log=log, phase=phase)
    if cfg.eval_filter and filter_index is None:
        if getattr(dataset, "train_partitioned", False):
            raise ValueError(
                "filtered eval on a rank's edge partition: the filter would "
                "cover only this rank's train slice; build FilterIndex from "
                "the whole dataset and pass it as filter_index")
        filter_index = FilterIndex(dataset)
    rank, ranks = ((plan.rank, plan.n) if plan is not None and not plan.vocab
                   else (0, 1))
    samplers = [
        EvalSampler(dataset, split, cfg.batch_size_eval, mode,
                    filter_index if cfg.eval_filter else None,
                    eval_percent=cfg.eval_percent, rank=rank, ranks=ranks,
                    seed=cfg.seed,
                    neg_sample_size=cfg.neg_sample_size_eval,
                    neg_deg_sample=cfg.neg_deg_sample_eval)
        for mode in ("head", "tail")
    ]
    return evaluate_with_samplers(model, state, samplers, phase=phase,
                                  log=log, plan=plan)


def combine_rank_metrics(ranks: np.ndarray, empty_msg: str,
                         plan=None) -> Dict[str, float]:
    """MRR/MR/HITS@{1,3,10} from this process's rank array.

    Under a replicated plan of several ranks each rank ranked its own
    stride, so six float64 partial sums (count, sum of ranks, of 1/rank,
    HITS@1/3/10) are all-gathered and added (JAX trainer.py:433-460); an
    empty stride joins with zeros.  Otherwise the local ranks are the
    global ones.  No rank at all raises ``empty_msg``."""
    r = np.asarray(ranks, np.float64)
    if plan is not None and not plan.vocab and plan.n > 1:
        local = torch.tensor([r.size, r.sum(), (1.0 / r).sum(),
                              (r <= 1).sum(), (r <= 3).sum(),
                              (r <= 10).sum()], dtype=torch.float64)
        tot = plan.comm.all_gather(local[None]).sum(0).tolist()
        if tot[0] == 0:
            raise ValueError(empty_msg)
        return {"MRR": tot[2] / tot[0], "MR": tot[1] / tot[0],
                "HITS@1": tot[3] / tot[0], "HITS@3": tot[4] / tot[0],
                "HITS@10": tot[5] / tot[0]}
    if r.size == 0:
        raise ValueError(empty_msg)
    return metrics_from_ranks(r)


# The JAX package's eval batching (dglke_tpu/trainer.py:761, 836): batches
# a group call, and the filter-list bytes of one full-entity chunk (a split
# is read in slabs of twice that).
EVAL_GROUP = 32
_MEGA_BUDGET = 512 << 20


def evaluate_with_samplers(model: KEModel, state: TrainState, samplers,
                           phase: str = "Test", log=print,
                           plan=None) -> Dict[str, float]:
    """Rank every batch of every sampler, a group of batches a call
    (models/eval_step.py): against all entities (_mega_eval), against its
    sampled negatives (_sampled_eval), or, for one CandidateEvalSampler,
    among its candidates (Valid-mode metrics).  Under a plan the metrics
    are global and logged by every rank, each with its own index ("[1]Test
    average MRR: ..." on rank 1).  On a card the log also gives the eval's
    CUDA graphs captured and replayed."""
    if any(isinstance(s, CandidateEvalSampler) for s in samplers):
        (sampler,) = samplers
        return evaluate_candidates(model, state, sampler, mode="Valid",
                                   log=log, plan=plan)
    calls = model.eval_calls
    graphs = (calls.captured, calls.replays)
    start = time.time()
    ranks = []
    for sampler in samplers:
        it = iter(sampler)
        first = next(it, None)
        if first is None:
            continue
        if "neg" in first:
            ranks += _sampled_eval(calls, state, chain([first], it), phase)
            continue
        # bounded slabs of ~2 x _MEGA_BUDGET filter bytes, so that a large
        # split never holds all its batches at once
        slab, slab_bytes = [first], _batch_bytes(first)
        for batch in it:
            if slab_bytes >= 2 * _MEGA_BUDGET:
                ranks += _mega_eval(calls, state, slab, phase)
                slab, slab_bytes = [], 0
            slab.append(batch)
            slab_bytes += _batch_bytes(batch)
        ranks += _mega_eval(calls, state, slab, phase)
    ranks = (np.concatenate(ranks) if ranks else np.zeros((0,), np.int64))
    metrics = combine_rank_metrics(
        ranks, "evaluation saw zero edges (empty eval split, or "
        "eval_percent too small)", plan)
    proc = 0 if plan is None else plan.rank
    for k, v in metrics.items():
        log(f"[{proc}]{phase} average {k}: {v}")
    log(f"[{proc}]{phase} takes {time.time() - start:.3f} seconds")
    _log_graphs(calls, state, graphs, f"[{proc}]{phase}", log)
    return metrics


def _log_graphs(calls, state, before: tuple, prefix: str, log) -> None:
    """The eval graph line of a card: graphs captured, replays since
    ``before``."""
    if calls.on_graphs(state):
        log(f"{prefix} eval CUDA graphs: {calls.captured - before[0]} "
            f"captured, {calls.replays - before[1]} replays")


def _batch_bytes(batch: dict) -> int:
    if "filter_ids" in batch:
        return batch["filter_ids"].nbytes + batch["filter_mask"].nbytes
    return 3 * batch["h"].nbytes


def _upload(arrays, device, dtype=np.int32):
    """numpy arrays packed as ``dtype`` into one host buffer (pinned for a
    card) and moved to ``device`` without blocking.  Returns (the host
    buffer, which must live until the work that reads its copy is read
    back; the device tensors, shaped as the arrays)."""
    arrays = [np.asarray(a, dtype) for a in arrays]
    buf = torch.empty(sum(a.size for a in arrays),
                      dtype=torch.from_numpy(arrays[0]).dtype,
                      pin_memory=device.type == "cuda")
    np.concatenate([a.reshape(-1) for a in arrays], out=buf.numpy())
    dev = buf.to(device, non_blocking=True)
    out, at = [], 0
    for a in arrays:
        out.append(dev[at:at + a.size].view(a.shape))
        at += a.size
    return buf, out


def _mega_eval(calls, state: TrainState, batches: list, phase: str) -> list:
    """Rank the full-entity ``batches`` (EvalSampler dicts) a group call at
    a time, batched as the JAX package's _mega_eval (dglke_tpu/trainer.py:
    764-823): bucketed by their pow2 filter width F, each bucket cut into
    chunks of ~_MEGA_BUDGET filter bytes; a bucket of several chunks runs
    every chunk as M groups of EVAL_GROUP batches, one of one chunk takes
    the group width of a pow2 ladder (< 2x padding).  The tail chunk of a
    bucket of several is padded to M groups where the calls run as CUDA
    graphs (one call shape a bucket); elsewhere it takes the ladder, as a
    bucket of one chunk does.  Each chunk is uploaded once, its M group
    calls made, and its ranks read back once.  Unfiltered eval passes zero
    filter lists made on the device.  Returns each batch's ranks trimmed
    to n_valid, in the batches' order (ranking is per row, so regrouping
    is exact)."""
    G = EVAL_GROUP
    B = len(batches[0]["h"])
    neg_head = batches[0]["neg_head"]
    filtered = "filter_ids" in batches[0]
    widths = np.array([b["filter_ids"].shape[1] if filtered else 8
                       for b in batches])
    dev = calls.model.device
    fixed = calls.on_graphs(state)
    out = [None] * len(batches)
    for f in np.unique(widths):
        f = int(f)
        idxs = np.nonzero(widths == f)[0]
        cap = max(G, _MEGA_BUDGET // (B * f * 5) // G * G)
        for c0 in range(0, len(idxs), cap):
            chunk = idxs[c0:c0 + cap]
            if len(idxs) > cap and fixed:
                g, m = G, cap // G
            else:
                g = min(G, 1 << max(0, len(chunk) - 1).bit_length())
                m = -(-len(chunk) // g)
            sel = np.concatenate(
                [chunk, np.repeat(chunk[:1], m * g - len(chunk))])
            host, (h, r, t) = _upload(
                [np.stack([batches[i][k] for i in sel]).reshape(m, g, B)
                 for k in ("h", "r", "t")], dev)
            hosts = [host]
            if filtered:
                lists = []
                for k, dtype in (("filter_ids", np.int32),
                                 ("filter_mask", np.uint8)):
                    host, (x,) = _upload([np.stack(
                        [batches[i][k] for i in sel]).reshape(m, g, B, f)],
                        dev, dtype)
                    hosts.append(host)
                    lists.append(x)
            else:
                lists = [[torch.zeros((g, B, 8), dtype=dtype, device=dev)] * m
                         for dtype in (torch.int32, torch.uint8)]
            ranks = torch.empty((m, g, B), dtype=torch.int64, device=dev)
            for i in range(m):
                ranks[i] = calls.full(state, h[i], r[i], t[i], lists[0][i],
                                      lists[1][i], neg_head=neg_head,
                                      phase=phase)
            ranks = ranks.reshape(m * g, B).cpu().numpy()
            del hosts   # read back: the uploads are done
            for j, i in enumerate(chunk):
                out[i] = ranks[j][:batches[i]["n_valid"]]
    return out


def _sampled_eval(calls, state: TrainState, batches, phase: str) -> list:
    """Rank sampled-negative batches a group of EVAL_GROUP a call, as the
    JAX package's flush_sampled (dglke_tpu/trainer.py:873-900): where the
    calls run as CUDA graphs the tail group is padded with copies of its
    first batch, so that one call shape serves every group (elsewhere it
    is ranked as it is), and a split without keep masks passes one
    all-ones mask made on the device.  The ranks are read back once, at
    the end.  Returns each batch's ranks trimmed to n_valid."""
    G = EVAL_GROUP
    dev = calls.model.device
    fixed = calls.on_graphs(state)
    ones = None
    hosts, groups, dev_ranks = [], [], []

    def flush(group):
        nonlocal ones
        pad = group + [group[0]] * ((G if fixed else len(group))
                                    - len(group))
        host, (h, r, t, neg, n_valid) = _upload(
            [np.stack([b[k] for b in pad]) for k in ("h", "r", "t", "neg")]
            + [[b["n_valid"] for b in pad]], dev)
        hosts.append(host)
        if "neg_keep" in pad[0]:
            host, (keep,) = _upload([np.stack([b["neg_keep"] for b in pad])],
                                    dev, np.uint8)
            hosts.append(host)
        else:
            if ones is None:   # a sampler's batches share one shape
                ones = torch.ones((G, h.shape[1], neg.shape[1]),
                                  dtype=torch.uint8, device=dev)
            keep = ones[:len(pad)]
        dev_ranks.append(calls.sampled(
            state, h, r, t, neg, keep, n_valid, neg_head=pad[0]["neg_head"],
            neg_deg_sample=pad[0]["neg_deg_sample"],
            phase=phase)[:len(group)].clone())
        groups.append(group)

    group = []
    for batch in batches:
        if len(group) == G:
            flush(group)
            group = []
        group.append(batch)
    flush(group)
    host_ranks = torch.cat(dev_ranks).cpu().numpy()
    del hosts   # read back: the uploads are done
    return [ranks[:b["n_valid"]]
            for ranks, b in zip(host_ranks, chain.from_iterable(groups))]


class CandidateEvalSampler:
    """The candidate-list split of a wikikg90M-style dataset: queries (h, r)
    [N, 2], each with its candidates [N, K] and, where the split has them,
    the answer's position among them [N] (the reference's
    WikiEvalSampler).  Ranked batch_size queries a call; (rank, ranks)
    strides the split (replicated tables under --dist)."""

    def __init__(self, edges: dict, batch_size: int, rank: int = 0,
                 ranks: int = 1):
        d = edges["h,r->t"]
        sl = slice(rank, None, ranks)
        self.hr = np.asarray(d["hr"], np.int32)[sl]
        self.ans = (np.asarray(d["t_correct_index"], np.int32)[sl]
                    if "t_correct_index" in d else None)
        self.cand = np.asarray(d["t_candidate"], np.int32)[sl]
        self.batch_size = batch_size


def evaluate_candidates(model: KEModel, state: TrainState,
                        sampler: CandidateEvalSampler, mode: str = "Valid",
                        save_path: Optional[str] = None,
                        log=print, plan=None) -> Optional[Dict[str, float]]:
    """Candidate-list eval.  Valid mode: MRR/MR/HITS from each answer's
    rank among its candidates (candidate_ranks: the answer counts itself,
    so the best rank is 2).  Test mode: each query's top-10 candidate
    positions (candidate_top) into save_path/test_{rank}.pkl, the
    reference's layout {"h,r->t": {"t_pred_top10": [N, min(10, K)] int32,
    and "t_correct_index" [N] where the split has answers}}.  Both are
    computed on the device a batch a call (models/eval_step.py), over
    chunks as the JAX package's make_candidate_megastep calls cut them
    (candidate_outputs).

    Under a plan: over replicated tables the sampler holds this rank's
    stride, the Valid metrics add the ranks' partial sums, and each rank
    writes its stride; over a vocab-sharded table every rank ranks every
    query (the candidates' rows come through the routed gather) and
    writes the stride rank::n of the predictions, the same files."""
    if mode == "Valid" and sampler.ans is None:
        raise ValueError(
            "Valid-mode candidate eval needs answer indices "
            "(t_correct_index missing from the candidate split)")
    rank = 0 if plan is None else plan.rank
    calls = model.eval_calls
    graphs = (calls.captured, calls.replays)
    out = candidate_outputs(calls, state, sampler, top=mode != "Valid",
                            phase=mode)
    _log_graphs(calls, state, graphs, f"[{rank}]{mode}", log)
    if mode == "Valid":
        metrics = combine_rank_metrics(
            out, "candidate evaluation saw zero queries", plan)
        for k, v in metrics.items():
            log(f"[{rank}]{mode} average {k}: {v}")
        return metrics
    top10 = out.astype(np.int32)
    sl = (slice(rank, None, plan.n) if plan is not None and plan.vocab
          else slice(None))
    result = {"h,r->t": {"t_pred_top10": top10[sl]}}
    if sampler.ans is not None:
        result["h,r->t"]["t_correct_index"] = sampler.ans[sl]
    if save_path:
        with open(os.path.join(save_path, f"test_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    return None


def candidate_outputs(calls, state: TrainState,
                      sampler: CandidateEvalSampler, *, top: bool,
                      phase: str) -> np.ndarray:
    """Each query's answer rank [N] (or with ``top`` its top-10 positions
    [N, min(10, K)]), chunked as the JAX package's evaluate_candidates
    (dglke_tpu/trainer.py:705-737): chunks of rows_cap queries, whose
    candidate lists take ~_MEGA_BUDGET bytes, the tail padded to a whole
    batch or, when the split spans several chunks and the calls run as CUDA
    graphs, to rows_cap, so that every call has one shape.  Each chunk is
    uploaded once, its batches ranked a call each, and its outputs read
    back once."""
    b = sampler.batch_size
    n = len(sampler.hr)
    n_cand = sampler.cand.shape[1]
    dev = calls.model.device
    rows_cap = max(b, _MEGA_BUDGET // (n_cand * 4) // b * b)
    fixed = calls.on_graphs(state)
    out = []
    for beg in range(0, n, rows_cap):
        hr = sampler.hr[beg:beg + rows_cap]
        cand = sampler.cand[beg:beg + rows_cap]
        ans = (sampler.ans[beg:beg + rows_cap] if sampler.ans is not None
               else np.zeros(len(hr), np.int32))
        nn = len(hr)
        pad = (rows_cap - nn) if n > rows_cap and fixed else (-nn % b)
        if pad:
            hr = np.concatenate([hr, np.repeat(hr[:1], pad, axis=0)])
            cand = np.concatenate([cand, np.repeat(cand[:1], pad, axis=0)])
            ans = np.concatenate([ans, np.repeat(ans[:1], pad)])
        m = len(hr) // b
        host, (query, cands, answers) = _upload(
            [hr.reshape(m, b, 2), cand.reshape(m, b, n_cand),
             ans.reshape(m, b)], dev)
        res = torch.empty((m, b, min(10, n_cand)) if top else (m, b),
                          dtype=torch.int64, device=dev)
        for i in range(m):
            res[i] = calls.candidates(state, query[i], cands[i], answers[i],
                                      top=top, phase=phase)
        out.append(res.reshape(m * b, -1).cpu().numpy()[:nn])
        del host   # read back: the upload is done
    if not out:
        return np.zeros((0, min(10, n_cand)) if top else (0,), np.int64)
    out = np.concatenate(out)
    return out if top else out.reshape(-1)
