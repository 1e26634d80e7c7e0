"""CUDA graphs of the fused calls: the capture stream each card shares, a
call's first run on it, its capture, and the group call that the training
routes build on (models/pipeline_step.py: the device pipeline's group;
models/fed_step.py: the host-fed groups and the host-table step;
models/eval_step.py takes the stream, the first run and the capture).

A group call runs s training steps in place on a state and returns their
logs as one [K, s] tensor.  On the CPU every call runs the group function.
On a card the first call runs it on the capture stream: a real training
call, which also does once what capture must not meet (each kernel
library's build and load, K3's function attributes and cluster occupancy
query, cuBLAS's workspace for that stream, a host table's first touch).
Every later call replays a CUDA graph of the group function, captured once
per memo key, as the JAX package's jit memo keys its compiles.  A failed
capture or replay raises: there is no eager fallback.

Under a ShardingPlan (--dist) the calls replay graphs where the plan's
collectives run over NCCL, which a graph captures on the capture stream
(the call's first, eager run on that stream is each collective's first
use there; the communicator started eagerly in mesh.init_distributed).
Over gloo the collectives are staged through host memory, which capture
cannot hold: there every call runs the group function eagerly.

The kernel wrappers count their launches in Python, which a replay does
not run: the counts of a capture are taken out again (rows.take_launches)
and each replay adds its graph's counts (rows.add_launches); so are the
bytes of a plan's collectives (Comm.take_bytes / add_bytes).  A replay
runs no Python either, so what the host advances per step (state.step)
is advanced around it.

A replay is the span ``group.replay`` and a capture ``graph.capture``
(tracing.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dglke_tpu_torch import tracing
from dglke_tpu_torch.ops import rows
from dglke_tpu_torch.tracing import no_span

# The capture stream of each card, shared by every fused call: torch keeps
# a cuBLAS workspace (~64 MB) for each stream that runs a cuBLAS call, for
# the rest of the process, so a stream for each call would hold that much
# more memory for every training run.
_capture_streams: dict = {}


def capture_stream(device) -> "torch.cuda.Stream":
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    stream = _capture_streams.get(index)
    if stream is None:
        stream = _capture_streams[index] = torch.cuda.Stream(device=index)
    return stream


def run_on_capture_stream(device, fn):
    """``fn()`` eagerly on the card's capture stream, after the current
    stream's work and before its later work.  Returns (the stream, fn's
    output: a tensor, a tuple of tensors and Nones, or None)."""
    main = torch.cuda.current_stream(device)
    stream = capture_stream(device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        out = fn()
    main.wait_stream(stream)
    for t in (out if isinstance(out, tuple) else (out,)):
        if t is not None:
            t.record_stream(main)
    return stream, out


def capture(fn, stream, pool=None, generators=()):
    """Capture ``fn()`` into a CUDA graph on ``stream`` (in ``pool`` when
    given, else a private pool); nothing runs.  ``generators`` are
    registered, so that seeds set before a replay reach it.  Only this
    thread is held to capture's rules: a host-fed run's Prefetcher thread
    may pin memory meanwhile.  Returns (graph, fn's output, rewritten by
    each replay, and the launches by wrapper of one replay)."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    before = dict(rows.launches)
    with tracing.span("graph.capture"), torch.cuda.graph(
            graph, pool=pool, stream=stream,
            capture_error_mode="thread_local"):
        out = fn()
    return graph, out, rows.take_launches(before)


def graphs_on(device, plan=None) -> bool:
    """Whether fused calls on ``device`` under ``plan`` (a ShardingPlan or
    None) replay CUDA graphs: on a card, without a plan or with one whose
    collectives run over NCCL."""
    return device.type == "cuda" and (plan is None
                                      or plan.comm.backend == "nccl")


def table_key(state) -> tuple:
    """The state tables' part of a memo key: each table's and its Adagrad
    state's data pointer (a mapped host table's CPU pointer), and its
    dtype."""
    return tuple((t.emb.data_ptr(), t.state_sum.data_ptr(), t.emb.dtype)
                 for t in (state.entity, state.relation, state.projection)
                 if t is not None)


@dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    logs: torch.Tensor    # the group's [K, s] logs, rewritten by each replay
    launches: dict        # launches by wrapper, one replay
    comm_bytes: int = 0   # the plan's collective bytes, one replay


class GroupCall:
    """s steps a call, with the memo of their CUDA graphs.  A subclass
    gives ``group(state, span)``, the group function (train_steps on its
    batches), and ``_key(state)``, the memo key of the call it set up;
    ``_generators()`` lists the device generators a graph reads.
    ``plan``: the ShardingPlan whose collectives the group function runs,
    or None."""

    def __init__(self, device, steps_per_call: int, plan=None):
        self.device, self.s, self.plan = device, steps_per_call, plan
        self.keys = None        # the log keys, from the first call
        self.graphs: dict = {}  # memo key -> _Graph
        self.stream = None      # the capture stream, once warmed up on it
        self.replays = 0

    @property
    def on_graphs(self) -> bool:
        """Whether the calls replay CUDA graphs (graphs_on)."""
        return graphs_on(self.device, self.plan)

    def group(self, state, span=no_span) -> torch.Tensor:
        raise NotImplementedError

    def _key(self, state) -> tuple:
        raise NotImplementedError

    def _generators(self) -> list:
        return []

    def train_steps(self, model, state, batches, first: int,
                    span=no_span) -> torch.Tensor:
        """The group function's loop, in place on ``state``: each of
        ``batches`` ((h, r, t, neg, impts, neg_head) on the device) one
        KEModel.train_step, or under --async_update with s > 1
        train_step_async with the group's last entity update applied at its
        end; each step one ``span``, numbered from ``first``.  Sets
        ``keys`` (the log keys) and returns the logs [K, s] in their
        order."""
        use_async = model.config.async_update and self.s > 1
        pending, logs = None, []
        for i, (h, r, t, neg, impts, neg_head) in enumerate(batches):
            with span(first + i):
                if use_async:
                    state, pending, log = model.train_step_async(
                        state, pending, h, r, t, neg, impts,
                        neg_head=neg_head)
                else:
                    state, log = model.train_step(state, h, r, t, neg, impts,
                                                  neg_head=neg_head)
            logs.append(log)
        model.flush_async(state, pending)
        self.keys = list(logs[0])
        return torch.stack([torch.stack([log[k] for log in logs])
                            for k in self.keys])

    def run(self, state, first: int, span=no_span) -> torch.Tensor:
        """One call on ``state``, its steps numbered from ``first``: the
        group function (each step one ``span``), or its graph replayed
        (one span of the whole call).  Returns the logs [K, s]."""
        if not self.on_graphs:
            return self.group(state, span)
        if self.stream is None:
            self.stream, logs = run_on_capture_stream(
                self.device, lambda: self.group(state, span))
            return logs
        key = self._key(state)
        entry = self.graphs.get(key)
        comm = None if self.plan is None else self.plan.comm
        if entry is None:
            step = state.step
            before = None if comm is None else comm.counters()
            entry = self.graphs[key] = _Graph(*capture(
                lambda: self.group(state), self.stream,
                generators=self._generators()))
            if comm is not None:
                entry.comm_bytes = comm.take_bytes(before)
            state.step = step
        with span(first, first + self.s - 1), tracing.span(
                "group.replay", self.device):
            entry.graph.replay()
        rows.add_launches(entry.launches)
        if comm is not None:
            comm.add_bytes(entry.comm_bytes)
        state.step += self.s
        self.replays += 1
        return entry.logs.clone()
