"""The fed step: a group of s training steps on batches the host sampled,
as one call (counterpart of the JAX package's make_train_step_packed at
s = 1 and its packed superstep at s > 1, dglke_tpu/models/ke_model.py:
535-610, which the host-fed route calls, dglke_tpu/trainer.py:230-251;
and of make_host_rows_step, ke_model.py:510-533, which host-table mode
calls once a step, dglke_tpu/host_table.py:133-210).

The host packs each TrainSampler batch's ids into one int32 buffer
(pack_batch: [h | r | t | neg], pinned when it goes to a card) and, before
each call, copies the group's buffers (and edge weights) into the call's
static input tensors on the device, one slot a step, with non-blocking
copies on the current stream.  The group function reads the batches from
those slots only, so nothing in it moves or reads a value between the host
and the card.  Each step is KEModel's train_step, or under --async_update
train_step_async with the group's last entity update applied at its end
(the JAX superstep's semantics): on tables on the device (the host-fed
route), or on host tables one step a call (host_table.host_fed_step: K1
gathers from the mapped tables, K2 writes them back).

On a card the calls replay CUDA graphs (models/cuda_graphs.py:GroupCall),
memoized on (the group's pattern of corruption sides, whether edge weights
come with it, the state tables' data pointers and dtypes): with s = 1
head-first and tail-first steps alternate, which takes two graphs.  A
call is the span ``group``, its staging ``group.begin`` (tracing.py).
"""

from __future__ import annotations

import numpy as np
import torch

from dglke_tpu_torch import tracing
from dglke_tpu_torch.models.cuda_graphs import GroupCall, table_key
from dglke_tpu_torch.tracing import no_span


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


def unpack_batch(packed: torch.Tensor, b: int) -> tuple:
    """(h, r, t, neg) of a packed batch of ``b`` rows."""
    return packed[:b], packed[b:2 * b], packed[2 * b:3 * b], packed[3 * b:]


class FedStep(GroupCall):
    """Runs ``steps_per_call`` steps of packed batches a call:
    ``step(state, batches, first, span)`` -> (state, {log key: [s]
    tensor}), ``batches`` s of pack_batch's tuples, ``first`` the number of
    the call's first step."""

    def __init__(self, model, steps_per_call: int):
        super().__init__(model.device, steps_per_call)
        self.model = model
        self.packed = None      # [s, 3b + negatives] int32 on the device
        self.impts = None       # [s, b] fp32 on the device, once needed
        self.with_impts = False
        self.neg_heads = ()     # the call's corruption sides, one a step
        self.b = 0
        self.first = 0          # the number of the call's first step

    def _stage(self, batches) -> None:
        """The call's batches into its static inputs, on the current
        stream."""
        if len(batches) != self.s:
            raise ValueError(f"a fed call takes {self.s} batches, not "
                             f"{len(batches)}")
        dev = self.device
        self.b = batches[0][3]
        if self.packed is None:
            self.packed = torch.empty((self.s, batches[0][0].numel()),
                                      dtype=torch.int32, device=dev)
        for slot, (packed, _, _, _) in zip(self.packed, batches):
            slot.copy_(packed, non_blocking=True)
        self.with_impts = batches[0][1] is not None
        if self.with_impts:
            if self.impts is None:
                self.impts = torch.empty((self.s, self.b),
                                         dtype=torch.float32, device=dev)
            for slot, (_, impts, _, _) in zip(self.impts, batches):
                slot.copy_(impts, non_blocking=True)
        self.neg_heads = tuple(bool(x[2]) for x in batches)

    def group(self, state, span=no_span) -> torch.Tensor:
        """The group function, eagerly, on the staged batches: the s steps
        in place on ``state``.  Returns the logs [K, s] (K the log keys, in
        self.keys' order)."""
        batches = ((*unpack_batch(self.packed[i], self.b),
                    self.impts[i] if self.with_impts else None, neg_head)
                   for i, neg_head in enumerate(self.neg_heads))
        return self.train_steps(self.model, state, batches, self.first, span)

    def __call__(self, state, batches, first: int = 0, span=no_span):
        with tracing.span("group", self.device):
            with tracing.span("group.begin"):
                self._stage(batches)
            self.first = first
            logs = self.run(state, first, span)
        return state, dict(zip(self.keys, logs))

    def _key(self, state):
        return (self.neg_heads, self.with_impts, table_key(state))
