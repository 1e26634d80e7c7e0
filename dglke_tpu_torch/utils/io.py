"""Checkpoint / config I/O (counterpart of dglke_tpu/utils/io.py).

The same npy contract as the JAX package, so either package reads the
other's checkpoints: ``{dataset}_{model}_entity.npy`` / ``_relation.npy``
(fp32, logical width) next to a ``config.json``, plus the Adagrad extras
``*_entity_state.npy`` / ``*_relation_state.npy`` and ``*_step.npy`` for
resuming.  TransR's projection table is written as
``{dataset}_{model}projection.npy`` (dgl-ke's spelling, without the
underscore, as the JAX package writes it) with
``*_projection_state.npy``; it is read under either spelling.

Tables on the card and host-resident tables (host_table.py) are saved by
the same function, _save_table: sliced to their logical width, upcast to
fp32 on the host (a bf16 table crosses the link as bf16), and streamed in
row chunks into the npy file when large, so that neither a table-sized
host copy nor a table-sized device buffer is ever made.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.models.ke_model import KEModel, TrainState
from dglke_tpu_torch.ops import rows
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


_STREAM_THRESHOLD = 256 << 20   # tables above this stream chunkwise
_STREAM_CHUNK = 64 << 20        # bytes of fp32 rows fetched at a time
_STREAM_WORKERS = 4             # fetches in flight


def _atomic_save_rows(path: str, get_chunk, n_rows: int, row_shape,
                      dtype=np.float32) -> None:
    """Stream an [n_rows, *row_shape] array into an npy file from a
    row-chunk fetcher, atomically (the tmp + replace contract of
    _atomic_save).  A small thread pool keeps _STREAM_WORKERS fetches in
    flight and overlaps them with the file write, and never holds more
    than that many chunks of host memory."""
    import concurrent.futures as cf

    dtype = np.dtype(dtype)
    row_bytes = int(np.prod(row_shape, dtype=np.int64)) * dtype.itemsize \
        if row_shape else dtype.itemsize
    chunk_rows = max(1, _STREAM_CHUNK // max(row_bytes, 1))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.lib.format.write_array_header_2_0(
            f, {"descr": np.lib.format.dtype_to_descr(dtype),
                "fortran_order": False,
                "shape": (n_rows,) + tuple(row_shape)})
        with cf.ThreadPoolExecutor(_STREAM_WORKERS) as ex:
            pending = []
            for s in range(0, n_rows, chunk_rows):
                pending.append(ex.submit(get_chunk, s,
                                         min(s + chunk_rows, n_rows)))
                # write the oldest chunk once the pool is full: fetches
                # stay ahead of the write, with bounded staging
                while len(pending) > _STREAM_WORKERS:
                    f.write(np.ascontiguousarray(
                        pending.pop(0).result(), dtype=dtype).tobytes())
            for fut in pending:
                f.write(np.ascontiguousarray(
                    fut.result(), dtype=dtype).tobytes())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _save_table(path: str, emb: torch.Tensor, n_rows: int, dim: int) -> None:
    """Persist a table on the card or in host memory, fp32 or bf16, as the
    fp32 npy artifact of its first ``n_rows`` rows and ``dim`` columns,
    streaming in row chunks above _STREAM_THRESHOLD bytes.  Each chunk is
    sliced before it crosses the link and upcast to fp32 on the host, so a
    bf16 table crosses as bf16 and the card holds no extra copy of it."""

    def get_chunk(a, b):
        return emb[a:b, :dim].cpu().float().numpy()

    if n_rows * dim * 4 < _STREAM_THRESHOLD:
        _atomic_save(path, get_chunk(0, n_rows))
    else:
        _atomic_save_rows(path, get_chunk, n_rows, (dim,), np.float32)


def save_model(config: KGEConfig, model: KEModel, state: TrainState,
               save_path: Optional[str] = None, emap_file=None,
               rmap_file=None, save_opt_state: bool = True) -> str:
    """Write the checkpoint of ``state``, a TrainState on the card or a
    host_table.HostState, and its config.json (which carries mix_cpu_gpu,
    so that the eval CLI adopts host mode)."""
    path = save_path or config.save_path
    os.makedirs(path, exist_ok=True)
    prefix = os.path.join(path, f"{config.dataset}_{config.model_name}_")
    rows.sync_mapped()   # K2 writes host tables asynchronously
    _save_table(prefix + "entity.npy", state.entity.emb, model.n_entities,
                model.entity_dim)
    _save_table(prefix + "relation.npy", state.relation.emb,
                model.n_relations, model.relation_dim)
    if state.projection is not None:
        _save_table(prefix[:-1] + "projection.npy", state.projection.emb,
                    int(state.projection.emb.shape[0]), model.proj_dim)
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


def load_config_json(path: str) -> dict:
    """A checkpoint's config.json as written, keys of either package."""
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)
