"""The eval's fused calls: one call a group of eval batches (counterpart of
the JAX package's make_eval_megastep, make_sampled_eval_superstep and
make_candidate_megastep with their jit memo, dglke_tpu/models/ke_model.py:
1085-1259).

Three group functions, each a KEModel method run eagerly:
  - full:       a [g, B] group of full-entity batches with [g, B, F] filter
                lists, ranked as one flattened [g*B] batch
                (KEModel.eval_group_ranks);
  - sampled:    a [G, B] group against [G, K] sampled negatives, with a
                [G, B, K] keep mask and each batch's real rows [G]
                (KEModel.eval_ranks_sampled);
  - candidates: one [B] batch of queries against [B, K] candidate lists,
                the answers' ranks or the top-10 positions
                (KEModel.candidate_eval).
The trainer's eval loops (trainer._mega_eval, _sampled_eval,
candidate_outputs) batch a split as the JAX package's do and hand each
call its inputs as device tensors; nothing in a group function reads a
device value on the host.  Host-resident tables (--mix_cpu_gpu) rank
their sampled groups by the same sampled call, K1 reading the rows from
the mapped tables; their full-entity eval (host_table.py, the JAX
package's _host_pos_side_fn and _host_block_counts_fn) makes two more:
  - host_pos_side: one direction's queries, ids [h | t | r], to their
                positive scores, side rows, relation rows (and TransR's
                projection rows) (host_table.host_pos_side);
  - host_block: one candidate block of the streamed entity table against
                every query chunk of every direction, added into each
                direction's counts (host_table.host_block_counts).  Its
                inputs are static tensors of the memo (HostBlocks): the
                directions' query rows, filter lists and int64 counts,
                filled once an eval; the block's place, two 0-d int64
                tensors written before each call; and one of two staging
                buffers of the block's rows, shared by every key of one
                block shape, which the caller refills by a copy on
                copy_stream outside the call.  The buffer's index is part
                of the key: one graph a buffer.

On the CPU, and under a ShardingPlan (--dist) whose collectives run over
gloo (staged through host memory, which capture cannot hold), every call
runs its group function.  On a card, without a plan or under one over
NCCL (the vocab plan's routed gather and its all-reduce of the counts
captured with the rest: cuda_graphs.graphs_on), the calls are
memoized on the model, one entry per
static call shape: (the kind, the eval phase, the static flags, every
input's shape and dtype, the tables' data pointers, shapes and dtypes), as
the JAX package's jit memo keys its compiles, so that the periodic --valid
evals of a training run reuse their graphs; there the trainer pads each
tail group or chunk to its bucket's call shape, as the JAX package does for
its compiles, and nowhere else.  The first call of a key runs the group
function on the capture stream shared with the training graphs
(models/cuda_graphs.py: one cuBLAS workspace a card), which also
does once what capture must not meet
(a kernel library's build and load, cuBLAS's workspace for that stream);
its second call captures a CUDA graph of the group function, reading from
static input tensors of the entry; that call and every later one copies
its inputs into them and replays the graph.  All eval graphs of a model
share one memory pool (a private pool for each would hold a [g*B, block]
score tile for every key): they replay one after another on one stream,
their static inputs lie outside the pool, and each replay's output, which
the next replay of any of them may overwrite, is copied out by the caller
at once.  A failed capture or replay raises: there is no eager fallback.

The kernel wrappers count their launches in Python, which a replay does
not run: the counts of a capture are taken out again (rows.take_launches)
and each replay adds its graph's counts (rows.add_launches); so are the
bytes of a plan's collectives (Comm.take_bytes / add_bytes).
"""

from __future__ import annotations

import weakref
from collections import Counter
from dataclasses import dataclass
from functools import partial
from typing import Optional

import torch

from dglke_tpu_torch.models.cuda_graphs import (
    capture,
    graphs_on,
    run_on_capture_stream,
)
from dglke_tpu_torch.ops import rows


@dataclass
class _Entry:
    inputs: list                       # static inputs (None where no input)
    graph: Optional["torch.cuda.CUDAGraph"] = None
    out: Optional[torch.Tensor] = None  # rewritten by each replay
    launches: Optional[dict] = None     # launches by wrapper, one replay
    comm_bytes: int = 0                 # collective bytes, one replay


# The inputs of host mode's block call that each direction brings.
_HOST_INPUTS = ("pos", "side", "rel", "proj", "fid", "fm")


@dataclass
class HostBlocks:
    """The static inputs of host mode's block call for one memo key, on the
    model's device: for each direction a dict of its query rows (pos, side,
    rel, TransR's proj or None) and filter lists (fid, fm), padded with
    zero rows, its int64 counts and its neg_head; the block's first row
    ``cs`` and the first row it counts ``start`` (0-d int64); and the key
    without the staging buffer's index."""
    static: tuple
    dirs: list
    cs: torch.Tensor
    start: torch.Tensor


class EvalCalls:
    """The eval's fused calls of one KEModel (its ``eval_calls``).

    ``captured`` and ``replays`` count over the model's life; ``keys``
    counts the calls of each memo key, graphs or not.

    The model is held weakly: a cycle through it would leave the graphs to
    the cyclic garbage collector, which may run, and destroy them, while
    another graph is being captured, and that invalidates the capture."""

    def __init__(self, model):
        self._model = weakref.ref(model)
        self.entries: dict = {}     # memo key -> _Entry
        self.keys: Counter = Counter()
        self.pool = None            # the memory pool the eval graphs share
        self.stream = None          # the capture stream, once used
        self.blocks: dict = {}      # memo key -> HostBlocks
        self.staging: dict = {}     # (rows, width) -> two staging buffers
        self._copy_stream = None
        self.captured = 0
        self.replays = 0

    @property
    def model(self):
        return self._model()

    def on_graphs(self, state) -> bool:
        """Whether this model's eval calls on ``state`` run as CUDA graphs:
        on a card, without a plan or under one over NCCL (tables on the
        card or mapped host tables alike; host tables take no plan)."""
        model = self.model
        return graphs_on(model.device, model.plan)

    @property
    def copy_stream(self) -> "torch.cuda.Stream":
        """The stream of host mode's staging copies (on a card)."""
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.model.device)
        return self._copy_stream

    # -- the calls -----------------------------------------------------------

    def full(self, state, h, r, t, filter_ids, filter_mask, *,
             neg_head: bool, phase: str) -> torch.Tensor:
        """Ranks [g, B] of a full-entity group."""
        fn = partial(self.model.eval_group_ranks, state, neg_head=neg_head)
        return self._call(state, ("full", phase, neg_head), fn,
                          (h, r, t, filter_ids, filter_mask))

    def sampled(self, state, h, r, t, neg, neg_keep, n_valid, *,
                neg_head: bool, neg_deg_sample: bool,
                phase: str) -> torch.Tensor:
        """Ranks [G, B] of a sampled-negative group."""
        fn = partial(self._sampled, state, neg_head=neg_head,
                     neg_deg_sample=neg_deg_sample)
        return self._call(state, ("sampled", phase, neg_head,
                                  neg_deg_sample), fn,
                          (h, r, t, neg, neg_keep, n_valid))

    def candidates(self, state, query, cand_ids, ans, *,
                   top: bool, phase: str) -> torch.Tensor:
        """One candidate batch: the ranks [B], or with ``top`` the top-10
        positions [B, min(10, K)]."""
        fn = partial(self.model.candidate_eval, state, top=top)
        return self._call(state, ("candidates", phase, top), fn,
                          (query, cand_ids, ans))

    def host_pos_side(self, state, fn, ids, *, neg_head: bool,
                      phase: str) -> tuple:
        """One direction's (pos, side, rel, proj or None) from ``fn(ids)``,
        host_table.host_pos_side on ids [h | t | r]: rewritten by the
        next call, copy them out."""
        return self._call(state, ("host_pos_side", phase, neg_head), fn,
                          (ids,))

    def host_blocks(self, state, dirs: list, n_pads: list, block: int,
                    q_cap: int, phase: str) -> HostBlocks:
        """The block call's static inputs for one eval, its directions'
        inputs copied in: each of ``dirs`` a dict of its query rows (pos,
        side, rel, proj) and filter lists (fid, fm), tensors, and its
        neg_head, padded with zero rows to its ``n_pads`` entry; the
        counts zeroed.  Memoized by the phase, the block, the query chunk
        ``q_cap``, TransR or not, each direction's (neg_head, padded rows,
        filter width) and the tables."""
        model = self.model
        static = ("host_block", phase, block, q_cap, model.is_transr,
                  tuple((d["neg_head"], n, d["fid"].shape[1])
                        for d, n in zip(dirs, n_pads)))
        key = self._key(state, static, ())
        hb = self.blocks.get(key)
        dev = model.device
        if hb is None:
            hb = self.blocks[key] = HostBlocks(static, [
                {"neg_head": d["neg_head"],
                 "counts": torch.zeros((n,), dtype=torch.int64, device=dev),
                 **{k: None if d[k] is None else d[k].new_zeros(
                     (n,) + d[k].shape[1:], device=dev) for k in _HOST_INPUTS}}
                for d, n in zip(dirs, n_pads)],
                torch.zeros((), dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
        for d, s in zip(dirs, hb.dirs):
            for k in _HOST_INPUTS:
                if d[k] is not None:
                    s[k][:len(d[k])].copy_(d[k])
                    s[k][len(d[k]):].zero_()
            s["counts"].zero_()
        return hb

    def host_buffers(self, rows: int, width: int) -> list:
        """The two fp32 staging buffers [rows, width] of the block call,
        shared by every key of that shape."""
        bufs = self.staging.get((rows, width))
        if bufs is None:
            bufs = self.staging[(rows, width)] = [
                torch.empty((rows, width), dtype=torch.float32,
                            device=self.model.device) for _ in range(2)]
        return bufs

    def host_block(self, state, hb: HostBlocks, buffer: int, fn) -> None:
        """One candidate block: ``fn()`` reads staging buffer ``buffer``
        and hb's static inputs, and adds into hb's counts."""
        self._call(state, hb.static + (buffer,), fn, ())

    def _sampled(self, state, h, r, t, neg, neg_keep, n_valid, *,
                 neg_head, neg_deg_sample):
        return self.model.eval_ranks_sampled(
            state, h, r, t, neg, neg_keep, neg_head=neg_head,
            neg_deg_sample=neg_deg_sample, n_valid=n_valid)

    # -- the memo ------------------------------------------------------------

    def _key(self, state, static: tuple, args: tuple) -> tuple:
        tables = [x for x in (state.entity, state.relation,
                              state.projection) if x is not None]
        return static + (
            tuple(None if a is None else (tuple(a.shape), a.dtype)
                  for a in args),
            tuple((x.emb.data_ptr(), tuple(x.emb.shape), x.emb.dtype)
                  for x in tables))

    def _call(self, state, static: tuple, fn, args: tuple):
        key = self._key(state, static, args)
        self.keys[key] += 1
        if not self.on_graphs(state):
            return fn(*args)
        entry = self.entries.get(key)
        if entry is None:
            self.stream, out = run_on_capture_stream(self.model.device,
                                                     lambda: fn(*args))
            self.entries[key] = _Entry([None if a is None
                                        else torch.empty_like(a)
                                        for a in args])
            return out
        for static_in, a in zip(entry.inputs, args):
            if static_in is not None:
                static_in.copy_(a)
        if entry.graph is None:
            self._capture(entry, fn)
        entry.graph.replay()
        rows.add_launches(entry.launches)
        comm = self._comm
        if comm is not None:
            comm.add_bytes(entry.comm_bytes)
        self.replays += 1
        return entry.out

    @property
    def _comm(self):
        plan = self.model.plan
        return None if plan is None else plan.comm

    def _capture(self, entry: _Entry, fn) -> None:
        """Capture the group function on the entry's static inputs into a
        CUDA graph in the eval graphs' shared pool; nothing runs."""
        comm = self._comm
        before = None if comm is None else comm.counters()
        entry.graph, entry.out, entry.launches = capture(
            lambda: fn(*entry.inputs), self.stream, pool=self.pool)
        if comm is not None:
            entry.comm_bytes = comm.take_bytes(before)
        if self.pool is None:
            self.pool = entry.graph.pool()
        self.captured += 1
