"""Training and evaluation loops (counterpart of dglke_tpu/trainer.py,
single device, device-resident pipeline).

The log format follows the reference ("[proc 0][Train](step/max) average
loss: ..." every log_interval; "[0]Test average MRR: ...") so existing
tooling can parse it.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import KGDataset
from dglke_tpu_torch.data.sampler import EvalSampler, FilterIndex
from dglke_tpu_torch.models.ke_model import (
    KEModel,
    TrainState,
    metrics_from_ranks,
)

# Domain tags of the two random streams: epoch permutations are seeded from
# (seed, 'perm', epoch) and each step's negatives from (seed, 'negS', step),
# so neither stream can repeat the other (the JAX package's 'negS'
# separation).
_PERM_TAG = 0x7065726D    # 'perm'
_NEG_TAG = 0x6E656753     # 'negS'


def _stream_seed(*words: int) -> int:
    """A 64-bit generator seed hashed from integer words."""
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


class DevicePipeline:
    """Device-resident training feed: the triples and two epoch
    permutations live on the device, and each step samples its batch there.

    Batches may straddle the epoch boundary: positions past the end of the
    current permutation continue into the next epoch's, so no tail edge is
    dropped (exact without-replacement epochs).  Negatives are uniform
    ``randint`` draws on the device.  Corruption sides alternate per step,
    head first.  Optional per-edge weights (``impts``) are gathered with the
    batch."""

    def __init__(self, model: KEModel, dataset: KGDataset, batch_size: int,
                 neg_total: int, seed: int = 0):
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
        self.neg_gen = torch.Generator(self.device)
        self.epoch = 0
        self.cur = self._permutation(0)
        self.nxt = self._permutation(1)
        self.pos = 0
        self.step_idx = 0

    def _permutation(self, epoch: int) -> torch.Tensor:
        gen = torch.Generator(self.device)
        gen.manual_seed(_stream_seed(self.seed, _PERM_TAG, epoch))
        return torch.randperm(self.n_edges, generator=gen,
                              device=self.device)

    def next_batch(self):
        """(h, r, t, neg, impts or None, neg_head) for the next step."""
        end = self.pos + self.b
        if end <= self.n_edges:
            idx = self.cur[self.pos:end]
        else:
            idx = torch.cat([self.cur[self.pos:],
                             self.nxt[:end - self.n_edges]])
        self.pos = end
        if self.pos >= self.n_edges:
            self.pos -= self.n_edges
            self.epoch += 1
            self.cur = self.nxt
            self.nxt = self._permutation(self.epoch + 1)
        h, r, t = self.triples[:, idx]
        self.neg_gen.manual_seed(_stream_seed(self.seed, _NEG_TAG,
                                              self.step_idx))
        neg = torch.randint(0, self.model.n_entities, (self.neg_total,),
                            generator=self.neg_gen, device=self.device,
                            dtype=torch.int32)
        impts = self.impts[idx] if self.impts is not None else None
        neg_head = self.step_idx % 2 == 0
        self.step_idx += 1
        return h, r, t, neg, impts, neg_head

    def run_step(self, state: TrainState):
        h, r, t, neg, impts, neg_head = self.next_batch()
        return self.model.train_step(state, h, r, t, neg, impts,
                                     neg_head=neg_head)


def train(config: KGEConfig, dataset: KGDataset,
          model: Optional[KEModel] = None,
          state: Optional[TrainState] = None,
          valid_samplers: Optional[list] = None,
          save_fn=None, log=print, device=None) -> tuple:
    """Run the training loop for config.max_step steps; returns (model,
    state, stats).  Runs on the card unless ``device="cpu"`` (or a model
    on the CPU) is given."""
    cfg = config
    model = model or KEModel(cfg, dataset.n_entities, dataset.n_relations,
                             device=device)
    if state is None:
        state = model.init_state()
    pipe = DevicePipeline(model, dataset, cfg.batch_size,
                          cfg.num_chunks * cfg.neg_sample_size,
                          seed=cfg.seed)
    logs: list = []
    valid_metrics = None
    start = tic = time.time()

    def flush_logs(step):
        nonlocal logs, tic
        for k in logs[0]:
            v = torch.stack([entry[k] for entry in logs]).mean().item()
            log(f"[proc 0][Train]({step}/{cfg.max_step}) average {k}: {v}")
        logs = []
        log(f"[proc 0][Train] {cfg.log_interval} steps take "
            f"{time.time() - tic:.3f} seconds")
        tic = time.time()

    for step in range(1, cfg.max_step + 1):
        state, log_dict = pipe.run_step(state)
        logs.append(log_dict)
        if step % cfg.log_interval == 0:
            flush_logs(step)
        if (cfg.valid and valid_samplers is not None
                and step % cfg.eval_interval == 0):
            valid_metrics = evaluate_with_samplers(
                model, state, valid_samplers, phase="Valid", log=log)
        if (save_fn is not None and cfg.save_interval > 0
                and step % cfg.save_interval == 0):
            save_fn(state, step)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    total = time.time() - start
    log(f"[proc 0]training takes {total} seconds")
    stats = {"train_time": total}
    if valid_metrics is not None:
        stats["valid_metrics"] = valid_metrics
    return model, state, stats


def evaluate(config: KGEConfig, dataset: KGDataset, model: KEModel,
             state: TrainState, split: str = "test",
             filter_index: Optional[FilterIndex] = None,
             log=print, phase: str = "Test") -> Dict[str, float]:
    """Filtered (or raw) full-entity ranking over both corrupt modes: every
    eval triple is ranked under head-corruption AND tail-corruption, and
    the metrics average over both."""
    cfg = config
    if 0 < cfg.neg_sample_size_eval < dataset.n_entities:
        raise NotImplementedError(
            "dglke_tpu_torch ranks against all entities only: sampled eval "
            "(--neg_sample_size_eval) is ROADMAP item A8")
    if cfg.eval_filter and filter_index is None:
        filter_index = FilterIndex(dataset)
    samplers = [
        EvalSampler(dataset, split, cfg.batch_size_eval, mode,
                    filter_index if cfg.eval_filter else None,
                    eval_percent=cfg.eval_percent, seed=cfg.seed)
        for mode in ("head", "tail")
    ]
    return evaluate_with_samplers(model, state, samplers, phase=phase,
                                  log=log)


def combine_rank_metrics(ranks: np.ndarray,
                         empty_msg: str) -> Dict[str, float]:
    """MRR/MR/HITS@{1,3,10} from one process's rank array."""
    r = np.asarray(ranks, np.float64)
    if r.size == 0:
        raise ValueError(empty_msg)
    return metrics_from_ranks(r)


def evaluate_with_samplers(model: KEModel, state: TrainState, samplers,
                           phase: str = "Test",
                           log=print) -> Dict[str, float]:
    """Rank every batch of every sampler against all entities."""
    dev = model.device
    start = time.time()
    ranks = []
    for sampler in samplers:
        for batch in sampler:
            h, r, t = (torch.as_tensor(batch[k], device=dev)
                       for k in ("h", "r", "t"))
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
            ranks.append(out[:batch["n_valid"]])
    ranks = (torch.cat(ranks).cpu().numpy() if ranks
             else np.zeros((0,), np.int64))
    metrics = combine_rank_metrics(
        ranks, "evaluation saw zero edges (empty eval split, or "
        "eval_percent too small)")
    for k, v in metrics.items():
        log(f"[0]{phase} average {k}: {v}")
    log(f"[0]{phase} takes {time.time() - start:.3f} seconds")
    return metrics
