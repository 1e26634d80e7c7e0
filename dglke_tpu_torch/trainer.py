"""Training and evaluation loops (counterpart of dglke_tpu/trainer.py,
single device).

Training is fed by the device-resident pipeline, or for a dataset smaller
than two batches by the host-fed TrainSampler, and runs in groups of
steps; --async_update defers entity updates inside each group.  On one
device each group of the pipeline is one fused call (on a card, one CUDA
graph replayed).
Evaluation ranks against every entity (filtered or raw), against sampled
negatives (--neg_sample_size_eval), or against a candidate list
(wikikg90M).  The log format follows the reference ("[proc 0][Train]
(step/max) average loss: ..." every log_interval; "[0]Test average MRR:
...") so existing tooling can parse it.  With --mix_cpu_gpu both loops go
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
from itertools import islice
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import KGDataset
from dglke_tpu_torch.data.sampler import EvalSampler, FilterIndex, TrainSampler
from dglke_tpu_torch.models.ke_model import (
    KEModel,
    TrainState,
    candidate_ranks,
    candidate_top,
    metrics_from_ranks,
)
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


def pack_batch(batch: dict, pin: bool) -> tuple:
    """A TrainSampler batch's ids packed into one int32 buffer (pinned when
    it goes to a card, so that its copy need not wait for the host):
    (packed [h | r | t | neg], impts or None, neg_head, batch size)."""
    ids = np.concatenate([batch["h"], batch["r"], batch["t"], batch["neg"]])
    packed = torch.empty(len(ids), dtype=torch.int32, pin_memory=pin)
    packed.numpy()[:] = ids
    impts = batch["impts"]
    if impts is not None:
        impts = torch.from_numpy(impts)
        impts = impts.pin_memory() if pin else impts
    return packed, impts, batch["neg_head"], len(batch["h"])


class HostFeed:
    """Host-fed training feed, the JAX package's route for datasets
    smaller than two batches: one TrainSampler batch a step (its numpy
    stream, a batch wrapping around a partition smaller than itself,
    alternating sides), sampled and packed ahead by a Prefetcher thread,
    the ids moved to the device as int32 in one transfer."""

    def __init__(self, model: KEModel, dataset: KGDataset, batch_size: int,
                 neg_sample_size: int, seed: int = 0):
        self.device = model.device
        pin = self.device.type == "cuda"
        self.prefetch = Prefetcher(
            TrainSampler(dataset, batch_size, neg_sample_size, seed=seed),
            lambda batch: pack_batch(batch, pin))

    def next_batch(self):
        """(h, r, t, neg, impts or None, neg_head) for the next step."""
        packed, impts, neg_head, b = next(self.prefetch)
        packed = packed.to(self.device, non_blocking=True)
        if impts is not None:
            impts = impts.to(self.device, non_blocking=True)
        return (packed[:b], packed[b:2 * b], packed[2 * b:3 * b],
                packed[3 * b:], impts, neg_head)

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
    pipeline, a smaller one by the host-fed TrainSampler, as in the JAX
    package.  Steps run in groups of ``steps_per_group``; with
    --async_update each step's entity update is applied after the next
    step's gather, and the group's last one at its end.  On one device the
    pipeline's groups are fused calls (models/pipeline_step.py): on a card
    one CUDA graph replayed a group, on the CPU the same group eagerly.

    ``plan``: this rank's parallel.mesh.ShardingPlan (--dist); ``dataset``
    is then this rank's edge partition, and ``model`` (built with the
    plan when omitted) steps through it.  Every rank takes max_step steps
    of batch_size rows from its own device pipeline, seeded from (seed,
    rank); a partition under one batch is refused, and the host-fed route
    does not run.  The step group is agreed on the smallest partition.

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
    device_route = plan is not None or n_train >= 2 * cfg.batch_size
    s = steps_per_group(cfg, n_train, device_route, log=log)
    fused = None   # the fused call of the single-device pipeline
    if device_route:
        feed = DevicePipeline(model, dataset, cfg.batch_size,
                              cfg.num_chunks * cfg.neg_sample_size,
                              seed=cfg.seed, rank=rank)
        if plan is None:
            fused = DevicePipelineStep(model, feed, s)
            how = (", one CUDA graph" if model.device.type == "cuda"
                   else ", each group eagerly on the CPU")
        else:
            how = f", {plan.n} ranks x {cfg.batch_size} rows a step"
        log(f"[proc 0]device-resident pipeline: {s} steps a group{how}")
    else:
        feed = HostFeed(model, dataset, cfg.batch_size, cfg.neg_sample_size,
                        seed=cfg.seed)
        log(f"[proc 0]host-fed TrainSampler ({dataset.n_train} train edges "
            f"< 2 x batch_size {cfg.batch_size}): {s} steps a group")
    use_async = cfg.async_update and s > 1
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
        if fused is not None:
            state, log_dict = fused(state, window.span)
            logs.append(log_dict)
        else:
            pending = None
            for i in range(s):
                with window.span(step + i):
                    t0 = time.time()
                    h, r, t, neg, impts, neg_head = feed.next_batch()
                    t1 = time.time()
                    if use_async:
                        state, pending, log_dict = model.train_step_async(
                            state, pending, h, r, t, neg, impts,
                            neg_head=neg_head)
                    else:
                        state, log_dict = model.train_step(
                            state, h, r, t, neg, impts, neg_head=neg_head)
                sample_time += t1 - t0
                update_time += time.time() - t1
                logs.append(log_dict)
            model.flush_async(state, pending)
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
    if fused is not None and model.device.type == "cuda":
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


# Sampled-eval batches ranked in one call: the JAX package's group (it
# vmaps groups of 32 batches); each row's rank is the same either way.
SAMPLED_GROUP = 32


def evaluate_with_samplers(model: KEModel, state: TrainState, samplers,
                           phase: str = "Test", log=print,
                           plan=None) -> Dict[str, float]:
    """Rank every batch of every sampler: against all entities, against
    its sampled negatives (groups of SAMPLED_GROUP batches a call), or, for
    one CandidateEvalSampler, among its candidates (Valid-mode metrics).
    Under a plan the metrics are global and logged by every rank, each
    with its own index ("[1]Test average MRR: ..." on rank 1)."""
    if any(isinstance(s, CandidateEvalSampler) for s in samplers):
        (sampler,) = samplers
        return evaluate_candidates(model, state, sampler, mode="Valid",
                                   log=log, plan=plan)
    start = time.time()
    ranks = []
    for sampler in samplers:
        it = iter(sampler)
        while True:
            group = list(islice(it, SAMPLED_GROUP))
            if not group:
                break
            if "neg" in group[0]:
                ranks += _sampled_ranks(model, state, group)
                continue
            for batch in group:
                ranks.append(_full_ranks(model, state, batch))
    ranks = (torch.cat(ranks).cpu().numpy() if ranks
             else np.zeros((0,), np.int64))
    metrics = combine_rank_metrics(
        ranks, "evaluation saw zero edges (empty eval split, or "
        "eval_percent too small)", plan)
    proc = 0 if plan is None else plan.rank
    for k, v in metrics.items():
        log(f"[{proc}]{phase} average {k}: {v}")
    log(f"[{proc}]{phase} takes {time.time() - start:.3f} seconds")
    return metrics


def _full_ranks(model: KEModel, state: TrainState, batch) -> torch.Tensor:
    """One batch ranked against all entities, trimmed to its real rows."""
    dev = model.device
    h, r, t = (torch.as_tensor(batch[k], device=dev) for k in ("h", "r", "t"))
    if "filter_ids" in batch:
        fid = torch.as_tensor(batch["filter_ids"], device=dev)
        fm = torch.as_tensor(batch["filter_mask"], device=dev)
    else:
        fid = torch.zeros((len(batch["h"]), 8), dtype=torch.int32,
                          device=dev)
        fm = torch.zeros((len(batch["h"]), 8), dtype=torch.uint8,
                         device=dev)
    out = model.eval_ranks(state, h, r, t, fid, fm,
                           neg_head=batch["neg_head"])
    return out[:batch["n_valid"]]


def _sampled_ranks(model: KEModel, state: TrainState, group) -> list:
    """A group of sampled-eval batches ranked in one call; each batch's
    ranks trimmed to its real rows."""
    dev = model.device

    def stack(k):
        return torch.as_tensor(np.stack([b[k] for b in group]), device=dev)

    n_valid = [b["n_valid"] for b in group]
    out = model.eval_ranks_sampled(
        state, stack("h"), stack("r"), stack("t"), stack("neg"),
        stack("neg_keep") if "neg_keep" in group[0] else None,
        neg_head=group[0]["neg_head"],
        neg_deg_sample=group[0]["neg_deg_sample"],
        n_valid=torch.as_tensor(n_valid, device=dev))
    return [out[i, :n] for i, n in enumerate(n_valid)]


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
    and "t_correct_index" [N] where the split has answers}}.

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
    dev = model.device
    b = sampler.batch_size
    n_cand = sampler.cand.shape[1]
    out = []
    for beg in range(0, len(sampler.hr), b):
        hr = torch.as_tensor(sampler.hr[beg:beg + b], device=dev)
        cand = torch.as_tensor(sampler.cand[beg:beg + b], device=dev)
        scores = model.candidate_scores(state, hr[:, 0], hr[:, 1], cand)
        if mode == "Valid":
            ans = torch.as_tensor(sampler.ans[beg:beg + b], device=dev)
            out.append(candidate_ranks(scores, ans))
        else:
            out.append(candidate_top(scores))
    if mode == "Valid":
        ranks = (torch.cat(out).cpu().numpy() if out
                 else np.zeros((0,), np.int64))
        metrics = combine_rank_metrics(
            ranks, "candidate evaluation saw zero queries", plan)
        for k, v in metrics.items():
            log(f"[{rank}]{mode} average {k}: {v}")
        return metrics
    top10 = (torch.cat(out).cpu().numpy().astype(np.int32) if out
             else np.zeros((0, min(10, n_cand)), np.int32))
    sl = (slice(rank, None, plan.n) if plan is not None and plan.vocab
          else slice(None))
    result = {"h,r->t": {"t_pred_top10": top10[sl]}}
    if sampler.ans is not None:
        result["h,r->t"]["t_correct_index"] = sampler.ans[sl]
    if save_path:
        with open(os.path.join(save_path, f"test_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    return None
