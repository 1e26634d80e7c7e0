"""Faults planted under the timed path, to show that the check sees them:
each a context manager that patches the port for its duration.

- ``unchanged_state``: every step leaves the tables as they were;
- ``half_batch``: the loss leaves out half of the batch and takes the
  mean over the rest;
- ``stale_negatives``: every group call after the first draws the first
  call's negatives again, as if the reseeding of the steps' generators
  never reached the captured graph; the first call, which runs eagerly,
  is sound.

A single-card cell has no exchange between chips to leave out."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name: str, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def unchanged_state():
    from dglke_tpu_torch.models.ke_model import KEModel
    stack = contextlib.ExitStack()
    for name in ("_update_entity", "_update_relation"):
        stack.enter_context(_patched(KEModel, name,
                                     lambda orig: lambda *a, **k: None))
    return stack


def half_batch():
    from dglke_tpu_torch.models.loss import LossGenerator

    def make(orig):
        def get_total_loss(self, pos, neg, edge_weight=None):
            n = pos.shape[0] // 2
            return orig(self, pos[:n], neg[:n],
                        None if edge_weight is None else edge_weight[:n])
        return get_total_loss
    return _patched(LossGenerator, "get_total_loss", make)


def stale_negatives():
    from dglke_tpu_torch.trainer import DevicePipeline

    def make(orig):
        def begin_group(self, s):
            orig(self, s)
            if self.step_idx > 0:
                for i in range(s):
                    self.gens[i].manual_seed(self._neg_seed(i))
        return begin_group
    return _patched(DevicePipeline, "begin_group", make)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "stale_negatives": stale_negatives}
