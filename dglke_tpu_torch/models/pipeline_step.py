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

Under a ShardingPlan (--dist) the same group function runs on the rank's
DevicePipeline (its streams seeded from (seed, rank)), each step's rows and
updates through the plan's collectives: the counterpart of the JAX
package's make_device_pipeline_step_multihost (ke_model.py:721-857).

On a card (under a plan, one whose collectives run over NCCL) the calls
replay CUDA graphs (models/cuda_graphs.py:GroupCall), memoized on (the
parity of the group's first step, the state tables' data pointers and
dtypes); with s = 1 head-first and tail-first steps
alternate, which takes two graphs.  Between replays the host only writes
where the group starts and reseeds its generators (DevicePipeline.
begin_group), and advances its own counters.  A call is the span
``group``, its begin_group ``group.begin`` (tracing.py).
"""

from __future__ import annotations

import torch

from dglke_tpu_torch import tracing
from dglke_tpu_torch.models.cuda_graphs import GroupCall, table_key
from dglke_tpu_torch.tracing import no_span


class DevicePipelineStep(GroupCall):
    """Runs one group of ``steps_per_call`` steps of ``pipeline`` a call:
    ``step(state, span)`` -> (state, {log key: [s] tensor}).  ``span``
    (trainer.ProfileWindow.span) marks each eager step, or a replayed
    group as a whole."""

    def __init__(self, model, pipeline, steps_per_call: int):
        if not 0 < steps_per_call * pipeline.b <= pipeline.n_edges:
            raise ValueError(
                f"a step group of {steps_per_call} x {pipeline.b} rows must "
                f"fit one epoch of {pipeline.n_edges} edges")
        super().__init__(pipeline.device, steps_per_call, model.plan)
        self.model, self.pipeline = model, pipeline

    def group(self, state, span=no_span) -> torch.Tensor:
        """The group function, eagerly, on the group that
        pipeline.begin_group set up: the s steps in place on ``state``.
        Returns the logs [K, s] (K the log keys, in self.keys' order)."""
        pipe = self.pipeline
        return self.train_steps(self.model, state, pipe.group_batches(self.s),
                                pipe.step_idx, span)

    def __call__(self, state, span=no_span):
        pipe = self.pipeline
        with tracing.span("group", self.device):
            with tracing.span("group.begin"):
                pipe.begin_group(self.s)
            logs = self.run(state, pipe.step_idx, span)
            pipe.end_group(self.s)
        return state, dict(zip(self.keys, logs))

    def _key(self, state):
        return (self.pipeline.step_idx % 2, table_key(state))

    def _generators(self):
        # each step's negative generator: the seeds begin_group sets before
        # a replay reach the graph
        return self.pipeline.gens[:self.s]
