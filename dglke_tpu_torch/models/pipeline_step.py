"""The device pipeline's fused call: one group of s training steps on a
trainer.DevicePipeline's batches as one call (counterpart of the JAX
package's KEModel.make_device_pipeline_step, dglke_tpu/models/ke_model.py:
612-719, which jits the group as one lax.scan that its
DevicePipeline.run_call launches once per group).

The group function runs the s steps eagerly: the batches come from device
tensors only (DevicePipeline.group_batches), each step is KEModel's
train_step, or under --async_update train_step_async with the group's last
entity update applied at its end, and the steps' logs come back as one
[K, s] tensor.  Nothing in it reads a device value on the host.

On the CPU every group runs the group function.  On a card the first group
runs it on the stream that capture uses: a real training group, which also
does once what capture must not meet (each kernel library's build and
load, K3's function attributes and cluster occupancy query, cuBLAS's
workspace for that stream).  Every later group replays a CUDA graph of the
group function, captured once per memo key: (the parity of the group's
first step, the state tables' data pointers and dtypes), as the JAX
package's memo keys its jit.  With s = 1 head-first and tail-first steps
alternate, which takes two graphs.  Between replays the host only writes
where the group starts and reseeds its generators (DevicePipeline.
begin_group), and advances its own counters.  A failed capture or replay
raises: there is no eager fallback.

The kernel wrappers count their launches in Python, which a replay does
not run: the counts of a capture are taken out again (rows.take_launches)
and each replay adds its graph's counts (rows.add_launches).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from dglke_tpu_torch.ops import rows


def _no_span(*steps):
    return contextlib.nullcontext()


# The capture stream of each card, shared by every fused call: torch keeps
# a cuBLAS workspace (~64 MB) for each stream that runs a cuBLAS call, for
# the rest of the process, so a stream for each call would hold that much
# more memory for every training run.
_capture_streams: dict = {}


def _capture_stream(device) -> "torch.cuda.Stream":
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    stream = _capture_streams.get(index)
    if stream is None:
        stream = _capture_streams[index] = torch.cuda.Stream(device=index)
    return stream


@dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    launches: dict        # launches by wrapper, one replay
    logs: torch.Tensor    # the group's [K, s] logs, rewritten by each replay


class DevicePipelineStep:
    """Runs one group of ``steps_per_call`` steps of ``pipeline`` a call:
    ``step(state, span)`` -> (state, {log key: [s] tensor}).  ``span``
    (trainer.ProfileWindow.span) marks each eager step, or a replayed
    group as a whole."""

    def __init__(self, model, pipeline, steps_per_call: int):
        if not 0 < steps_per_call * pipeline.b <= pipeline.n_edges:
            raise ValueError(
                f"a step group of {steps_per_call} x {pipeline.b} rows must "
                f"fit one epoch of {pipeline.n_edges} edges")
        self.model, self.pipeline, self.s = model, pipeline, steps_per_call
        self.use_async = model.config.async_update and steps_per_call > 1
        self.keys = None        # the log keys, from the first group
        self.graphs: dict = {}  # memo key -> _Graph
        self.stream = None      # the capture stream, once warmed up on it
        self.replays = 0

    def group(self, state, span=_no_span) -> torch.Tensor:
        """The group function, eagerly, on the group that
        pipeline.begin_group set up: the s steps in place on ``state``.
        Returns the logs [K, s] (K the log keys, in self.keys' order)."""
        model, first = self.model, self.pipeline.step_idx
        pending, logs = None, []
        for i, (h, r, t, neg, impts, neg_head) in enumerate(
                self.pipeline.group_batches(self.s)):
            with span(first + i):
                if self.use_async:
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

    def __call__(self, state, span=_no_span):
        pipe = self.pipeline
        pipe.begin_group(self.s)
        if pipe.device.type != "cuda":
            logs = self.group(state, span)
        elif self.stream is None:
            logs = self._warm_up(state, span)
        else:
            entry = self.graphs.get(self._key(state))
            if entry is None:
                entry = self._capture(state)
            first = pipe.step_idx
            with span(first, first + self.s - 1):
                entry.graph.replay()
            rows.add_launches(entry.launches)
            state.step += self.s
            self.replays += 1
            logs = entry.logs.clone()
        pipe.end_group(self.s)
        return state, dict(zip(self.keys, logs))

    def _key(self, state):
        tables = [t for t in (state.entity, state.relation, state.projection)
                  if t is not None]
        return (self.pipeline.step_idx % 2,
                tuple((t.emb.data_ptr(), t.state_sum.data_ptr(), t.emb.dtype)
                      for t in tables))

    def _warm_up(self, state, span):
        """The first group, eagerly on the capture stream."""
        dev = self.pipeline.device
        main = torch.cuda.current_stream(dev)
        stream = _capture_stream(dev)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            logs = self.group(state, span)
        main.wait_stream(stream)
        logs.record_stream(main)
        self.stream = stream
        return logs

    def _capture(self, state) -> _Graph:
        """Capture the group function into a CUDA graph under this group's
        memo key; nothing runs.  Each step's negative generator is
        registered, so that the seeds begin_group sets before a replay
        reach it."""
        key = self._key(state)
        graph = torch.cuda.CUDAGraph()
        for gen in self.pipeline.gens[:self.s]:
            graph.register_generator_state(gen)
        before, step = dict(rows.launches), state.step
        with torch.cuda.graph(graph, stream=self.stream):
            logs = self.group(state)
        state.step = step
        entry = self.graphs[key] = _Graph(graph, rows.take_launches(before),
                                          logs)
        return entry
