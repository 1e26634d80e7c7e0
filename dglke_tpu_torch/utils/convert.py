"""Carry training state across packages as numpy arrays.

``state_from_numpy`` takes the JAX package's TrainState with its arrays on
the host (``jax.device_get(state)``), or anything with the same attribute
layout (``entity.emb``, ``entity.state_sum``, ``relation.emb``,
``relation.state_sum``, ``step``, and TransR's ``projection.emb`` and
``projection.state_sum``), and builds this package's TrainState.
``state_to_numpy`` returns that layout as numpy arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dglke_tpu_torch.device import resolve_device
from dglke_tpu_torch.models.ke_model import TrainState
from dglke_tpu_torch.ops.embedding import EmbeddingState


class NumpyTable(NamedTuple):
    emb: np.ndarray         # [num, dim] float32
    state_sum: np.ndarray   # [num] float32


class NumpyState(NamedTuple):
    entity: NumpyTable
    relation: NumpyTable
    step: np.ndarray        # int32 scalar
    projection: Optional[NumpyTable] = None   # TransR only


def _to_tensor(arr, device) -> torch.Tensor:
    """A copy of `arr` on `device`: the port updates its tables in place,
    so it never shares the caller's buffers."""
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bf16; move the bits and reinterpret them
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def state_from_numpy(arrays, device=None) -> TrainState:
    """The port's TrainState from host arrays (see module docstring).
    Tables keep their dtype (fp32 or bf16); state_sum becomes fp32."""
    dev = resolve_device(device)

    def table(t) -> EmbeddingState:
        return EmbeddingState(
            _to_tensor(t.emb, dev),
            _to_tensor(t.state_sum, dev).to(torch.float32))

    proj = getattr(arrays, "projection", None)
    return TrainState(table(arrays.entity), table(arrays.relation),
                      step=int(np.asarray(arrays.step)),
                      projection=None if proj is None else table(proj))


def state_to_numpy(state: TrainState) -> NumpyState:
    """Host copy of ``state``; bf16 tables come back upcast to fp32
    (exact)."""

    def table(t: EmbeddingState) -> NumpyTable:
        return NumpyTable(t.emb.float().cpu().numpy(),
                          t.state_sum.cpu().numpy())

    return NumpyState(table(state.entity), table(state.relation),
                      np.asarray(state.step, np.int32),
                      None if state.projection is None
                      else table(state.projection))
