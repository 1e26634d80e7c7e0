"""Checkpoint / config I/O (counterpart of dglke_tpu/utils/io.py).

The same npy contract as the JAX package, so either package reads the
other's checkpoints: ``{dataset}_{model}_entity.npy`` / ``_relation.npy``
(fp32, logical width) next to a ``config.json``, plus the Adagrad extras
``*_entity_state.npy`` / ``*_relation_state.npy`` and ``*_step.npy`` for
resuming.  TransR's projection table is written as
``{dataset}_{model}projection.npy`` (dgl-ke's spelling, without the
underscore, as the JAX package writes it) with
``*_projection_state.npy``; it is read under either spelling.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.models.ke_model import KEModel, TrainState
from dglke_tpu_torch.ops.embedding import EmbeddingState


def _atomic_save(path: str, arr: np.ndarray) -> None:
    """np.save via tmp-file + os.replace, so a crash mid-write never
    corrupts an existing artifact (periodic checkpoints overwrite in
    place)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_model(config: KGEConfig, model: KEModel, state: TrainState,
               save_path: Optional[str] = None, emap_file=None,
               rmap_file=None, save_opt_state: bool = True) -> str:
    path = save_path or config.save_path
    os.makedirs(path, exist_ok=True)
    prefix = os.path.join(path, f"{config.dataset}_{config.model_name}_")
    # bf16 tables are upcast: the npy artifact contract is fp32
    _atomic_save(prefix + "entity.npy", state.entity.emb[
        :model.n_entities, :model.entity_dim].float().cpu().numpy())
    _atomic_save(prefix + "relation.npy", state.relation.emb[
        :model.n_relations, :model.relation_dim].float().cpu().numpy())
    if state.projection is not None:
        _atomic_save(prefix[:-1] + "projection.npy",
                     state.projection.emb.float().cpu().numpy())
    if save_opt_state:
        _atomic_save(prefix + "entity_state.npy",
                     state.entity.state_sum.cpu().numpy())
        _atomic_save(prefix + "relation_state.npy",
                     state.relation.state_sum.cpu().numpy())
        if state.projection is not None:
            _atomic_save(prefix + "projection_state.npy",
                         state.projection.state_sum.cpu().numpy())
        _atomic_save(prefix + "step.npy", np.asarray(state.step, np.int32))
    config.save(path, emap_file, rmap_file)
    return path


def table_artifact_arrays(config: KGEConfig, path: str, name: str):
    """Read one table's npy artifacts as host arrays: (emb, state_sum); a
    checkpoint without the Adagrad extra gets a zero state_sum."""
    prefix = os.path.join(path, f"{config.dataset}_{config.model_name}_")
    fname = prefix + f"{name}.npy"
    if name == "projection" and not os.path.exists(fname):
        fname = prefix[:-1] + "projection.npy"
    emb = np.load(fname)
    state_file = prefix + f"{name}_state.npy"
    if os.path.exists(state_file):
        ss = np.load(state_file)
    else:
        ss = np.zeros((emb.shape[0],), np.float32)
    return emb, ss


def saved_step(config: KGEConfig, path: str) -> int:
    """The step counter saved alongside the tables (0 when absent)."""
    step_file = os.path.join(
        path, f"{config.dataset}_{config.model_name}_step.npy")
    return int(np.load(step_file)) if os.path.exists(step_file) else 0


def load_model_state(config: KGEConfig, model: KEModel,
                     path: str) -> TrainState:
    """A TrainState on the model's device, in the configured table dtype."""

    def load_table(name) -> EmbeddingState:
        emb, ss = table_artifact_arrays(config, path, name)
        return EmbeddingState(
            torch.as_tensor(emb, device=model.device).to(model.table_dtype),
            torch.as_tensor(ss, dtype=torch.float32, device=model.device))

    return TrainState(load_table("entity"), load_table("relation"),
                      step=saved_step(config, path),
                      projection=(load_table("projection")
                                  if model.is_transr else None))


def load_config(path: str) -> KGEConfig:
    return KGEConfig.load(os.path.join(path, "config.json"))
