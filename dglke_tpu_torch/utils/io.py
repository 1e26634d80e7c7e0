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

A --dist run (parallel/mesh.py) saves in one of two ways.  Without
--sharded_ckpt, ``save_model_dist`` writes the npy layout above on rank 0,
a vocab-sharded entity table streamed to it from its owners in row chunks
(no card ever holds the whole table).  With --sharded_ckpt,
``save_sharded`` writes each rank's part under ``sharded_state/`` as npy
files with a layout record, which ``load_sharded`` restores onto as many
ranks.  That format is this package's own: the JAX package's sharded
checkpoints (orbax) are read by the JAX package only, and the npy layout
is the interchange.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

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


def _write_rows(path: str, chunks: Iterable[np.ndarray], n_rows: int,
                row_shape, dtype=np.float32) -> None:
    """Write an [n_rows, *row_shape] npy file from row chunks given in
    order, atomically (tmp + replace)."""
    dtype = np.dtype(dtype)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.lib.format.write_array_header_2_0(
            f, {"descr": np.lib.format.dtype_to_descr(dtype),
                "fortran_order": False,
                "shape": (n_rows,) + tuple(row_shape)})
        for chunk in chunks:
            f.write(np.ascontiguousarray(chunk, dtype=dtype).tobytes())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


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

    def chunks():
        with cf.ThreadPoolExecutor(_STREAM_WORKERS) as ex:
            pending = []
            for s in range(0, n_rows, chunk_rows):
                pending.append(ex.submit(get_chunk, s,
                                         min(s + chunk_rows, n_rows)))
                # write the oldest chunk once the pool is full: fetches
                # stay ahead of the write, with bounded staging
                while len(pending) > _STREAM_WORKERS:
                    yield pending.pop(0).result()
            for fut in pending:
                yield fut.result()

    _write_rows(path, chunks(), n_rows, row_shape, dtype)


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
    if save_opt_state:
        _atomic_save(prefix + "entity_state.npy",
                     state.entity.state_sum.cpu().numpy())
    _save_replicated(model, state, prefix, prefix[:-1] + "projection.npy",
                     save_opt_state)
    config.save(path, emap_file, rmap_file)
    return path


def table_artifact_arrays(config: KGEConfig, path: str, name: str,
                          mmap_mode=None):
    """Read one table's npy artifacts as host arrays: (emb, state_sum); a
    checkpoint without the Adagrad extra gets a zero state_sum.
    ``mmap_mode="r"`` maps the files instead of reading them."""
    prefix = os.path.join(path, f"{config.dataset}_{config.model_name}_")
    fname = prefix + f"{name}.npy"
    if name == "projection" and not os.path.exists(fname):
        fname = prefix[:-1] + "projection.npy"
    emb = np.load(fname, mmap_mode=mmap_mode)
    state_file = prefix + f"{name}_state.npy"
    if os.path.exists(state_file):
        ss = np.load(state_file, mmap_mode=mmap_mode)
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
    """A TrainState on the model's device, in the configured table dtype.
    Under a vocab plan (model.plan) each rank reads only its own entity
    rows, through a mapping of the file."""
    plan = model.plan

    def load_table(name) -> EmbeddingState:
        sharded = plan is not None and plan.vocab and name == "entity"
        emb, ss = table_artifact_arrays(config, path, name,
                                        mmap_mode="r" if sharded else None)
        if sharded:
            emb, ss = plan.shard_rows(emb), plan.shard_rows(ss)
        return EmbeddingState(
            torch.as_tensor(np.asarray(emb), device=model.device).to(
                model.table_dtype),
            torch.as_tensor(np.asarray(ss), dtype=torch.float32,
                            device=model.device))

    return TrainState(load_table("entity"), load_table("relation"),
                      step=saved_step(config, path),
                      projection=(load_table("projection")
                                  if model.is_transr else None))


def load_raw_emb(path: str, prefix: str, name: str) -> np.ndarray:
    """One table of an npy checkpoint, ``{path}/{prefix}_{name}.npy``, as
    saved (the JAX package's load_raw_emb)."""
    return np.load(os.path.join(path, f"{prefix}_{name}.npy"))


def load_config(path: str) -> KGEConfig:
    return KGEConfig.load(os.path.join(path, "config.json"))


def load_config_json(path: str) -> dict:
    """A checkpoint's config.json as written, keys of either package."""
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# --dist: the streamed npy save and the sharded checkpoints

SHARDED_DIRNAME = "sharded_state"
LAYOUT_FILE = "layout.json"
SHARDED_FORMAT = "dglke_tpu_torch-sharded"


def _owner_pieces(plan, n_rows: int, chunk_rows: int):
    """(owner, first row, end row) pieces of rows [0, n_rows) in order,
    each within one owner's range and at most chunk_rows long."""
    for owner in range(plan.n):
        lo, hi = owner * plan.per, min((owner + 1) * plan.per, n_rows)
        for a in range(lo, hi, chunk_rows):
            yield owner, a, min(a + chunk_rows, hi)


def _stream_to_root(plan, path: str, local: torch.Tensor, n_rows: int,
                    width: Optional[int]) -> None:
    """Collective: rank 0 writes the fp32 npy file of a vocab-sharded
    table's first n_rows rows (``width`` columns, or a 1-D state_sum when
    None), each owner sending its rows in chunks of _STREAM_CHUNK bytes;
    no rank holds more than one chunk of another's rows."""
    comm = plan.comm
    row_shape = () if width is None else (width,)
    chunk_rows = max(1, _STREAM_CHUNK // (4 * (width or 1)))

    def rows_of(a, b):
        part = local[a - plan.lo:b - plan.lo]
        return (part if width is None else part[:, :width]).float()

    def chunks():
        for owner, a, b in _owner_pieces(plan, n_rows, chunk_rows):
            if owner == 0:
                yield rows_of(a, b).cpu().numpy()
            else:
                yield comm.recv((b - a,) + row_shape, torch.float32, owner,
                                device="cpu").numpy()

    if plan.rank == 0:
        _write_rows(path, chunks(), n_rows, row_shape, np.float32)
        return
    for owner, a, b in _owner_pieces(plan, n_rows, chunk_rows):
        if owner == plan.rank:
            comm.send(rows_of(a, b), 0)


def save_model_dist(config: KGEConfig, model: KEModel, state: TrainState,
                    emap_file=None, rmap_file=None) -> str:
    """Collective: the npy checkpoint of a --dist run (model.plan), the
    same files save_model writes, by rank 0.  A replicated run's rank 0
    holds every table; a vocab-sharded entity table and its state_sum
    stream to rank 0 from their owners in row chunks, unpadded."""
    plan = model.plan
    path = config.save_path
    if not plan.vocab:
        if plan.rank == 0:
            save_model(config, model, state, emap_file=emap_file,
                       rmap_file=rmap_file)
        plan.comm.barrier()
        return path
    prefix = os.path.join(path, f"{config.dataset}_{config.model_name}_")
    if plan.rank == 0:
        os.makedirs(path, exist_ok=True)
    _stream_to_root(plan, prefix + "entity.npy", state.entity.emb,
                    model.n_entities, model.entity_dim)
    _stream_to_root(plan, prefix + "entity_state.npy",
                    state.entity.state_sum, model.n_entities, None)
    if plan.rank == 0:
        _save_replicated(model, state, prefix, prefix[:-1] + "projection.npy")
        config.save(path, emap_file, rmap_file)
    plan.comm.barrier()
    return path


def _save_replicated(model, state, prefix: str, proj_path: str,
                     opt_state: bool = True) -> None:
    """The relation (and TransR projection, at ``proj_path``) tables under
    ``prefix``, with their Adagrad state and the step counter when
    ``opt_state``."""
    _save_table(prefix + "relation.npy", state.relation.emb,
                model.n_relations, model.relation_dim)
    if state.projection is not None:
        _save_table(proj_path, state.projection.emb,
                    int(state.projection.emb.shape[0]), model.proj_dim)
    if not opt_state:
        return
    _atomic_save(prefix + "relation_state.npy",
                 state.relation.state_sum.cpu().numpy())
    if state.projection is not None:
        _atomic_save(prefix + "projection_state.npy",
                     state.projection.state_sum.cpu().numpy())
    _atomic_save(prefix + "step.npy", np.asarray(state.step, np.int32))


def has_sharded(path: str) -> bool:
    """A sharded checkpoint of either package lies at ``path``."""
    return os.path.isdir(os.path.join(path, SHARDED_DIRNAME))


def sharded_layout(path: str) -> dict:
    """The layout record of this package's sharded checkpoint at ``path``;
    refuses the JAX package's (orbax) format by name."""
    f = os.path.join(path, SHARDED_DIRNAME, LAYOUT_FILE)
    if not os.path.exists(f):
        raise SystemExit(
            f"{os.path.join(path, SHARDED_DIRNAME)} is not a "
            f"dglke_tpu_torch sharded checkpoint (no {LAYOUT_FILE}): it is "
            f"the JAX package's orbax format, which only dglke_tpu reads; "
            f"write the npy checkpoint (no --sharded_ckpt) to carry tables "
            f"between the packages")
    with open(f) as fh:
        layout = json.load(fh)
    if layout.get("format") != SHARDED_FORMAT:
        raise SystemExit(f"{f}: unknown sharded format "
                         f"{layout.get('format')!r}")
    return layout


def _rank_dir(path: str, rank: int) -> str:
    return os.path.join(path, SHARDED_DIRNAME, f"rank_{rank}")


def save_sharded(config: KGEConfig, model: KEModel, state: TrainState,
                 path: str) -> str:
    """Collective: each rank's tables under ``path/sharded_state/``:
    ``rank_<r>/entity.npy`` and ``entity_state.npy`` (the rank's real rows
    under vocab sharding; rank 0's whole tables when replicated), the
    replicated tables and the step counter once, in ``rank_0/``, and
    ``layout.json`` (format, plan, ranks, rows a rank, widths).  Every
    rank writes its own files, on a file system all ranks share; no table
    is gathered anywhere.  Without a plan (model.plan None) one rank's."""
    plan = model.plan
    rank = 0 if plan is None else plan.rank
    n = 1 if plan is None else plan.n
    vocab = plan is not None and plan.vocab
    rdir = _rank_dir(path, rank)
    rows.sync_mapped()
    if vocab or rank == 0:
        os.makedirs(rdir, exist_ok=True)
        n_real = plan.n_real if vocab else model.n_entities
        _save_table(os.path.join(rdir, "entity.npy"), state.entity.emb,
                    n_real, model.entity_dim)
        _atomic_save(os.path.join(rdir, "entity_state.npy"),
                     state.entity.state_sum[:n_real].cpu().numpy())
    if rank == 0:
        _save_replicated(model, state, os.path.join(rdir, ""),
                         os.path.join(rdir, "projection.npy"))
        layout = {"format": SHARDED_FORMAT,
                  "table_sharding": "vocab" if vocab else "replicated",
                  "world_size": n, "n_entities": model.n_entities,
                  "rows_per_rank": plan.per if vocab else model.n_entities,
                  "entity_dim": model.entity_dim,
                  "relation_dim": model.relation_dim,
                  "emb_dtype": config.emb_dtype, "step": int(state.step)}
        _atomic_save_json(os.path.join(path, SHARDED_DIRNAME, LAYOUT_FILE),
                          layout)
    if plan is not None:
        plan.comm.barrier()
    return os.path.join(path, SHARDED_DIRNAME)


def _atomic_save_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=4)
    os.replace(tmp, path)


def load_sharded(config: KGEConfig, model: KEModel, path: str) -> TrainState:
    """This rank's TrainState from the sharded checkpoint at ``path``, on the
    model's device: its entity rows (padded to the plan's rows a rank) and
    the replicated tables.  Refuses a checkpoint written by another number
    of ranks or under another table sharding."""
    plan = model.plan
    layout = sharded_layout(path)
    n = 1 if plan is None else plan.n
    sharding = "replicated" if plan is None else plan.table_sharding
    if layout["world_size"] != n:
        raise SystemExit(
            f"the sharded checkpoint at {path} was written by "
            f"{layout['world_size']} rank(s); restore it onto "
            f"{layout['world_size']} rank(s) (this run has {n})")
    if layout["table_sharding"] != sharding and n > 1:
        raise SystemExit(
            f"the sharded checkpoint at {path} holds "
            f"{layout['table_sharding']} tables; restore it with "
            f"--table_sharding {layout['table_sharding']} (this run has "
            f"{sharding})")
    if (layout["n_entities"], layout["entity_dim"]) != (
            model.n_entities, model.entity_dim):
        raise SystemExit(
            f"the sharded checkpoint at {path} holds {layout['n_entities']} "
            f"x {layout['entity_dim']} entities, not {model.n_entities} x "
            f"{model.entity_dim}")
    vocab = plan is not None and plan.vocab
    rdir = _rank_dir(path, plan.rank if vocab else 0)
    root = os.path.join(_rank_dir(path, 0), "")
    dev, dtype = model.device, model.table_dtype

    def table(emb, ss, pad_to=None) -> EmbeddingState:
        emb = torch.as_tensor(emb, device=dev).to(dtype)
        ss = torch.as_tensor(ss, dtype=torch.float32, device=dev)
        if pad_to is not None and pad_to > emb.shape[0]:
            extra = pad_to - emb.shape[0]
            emb = torch.cat([emb, emb.new_zeros((extra, emb.shape[1]))])
            ss = torch.cat([ss, ss.new_zeros((extra,))])
        return EmbeddingState(emb.contiguous(), ss.contiguous())

    entity = table(np.load(os.path.join(rdir, "entity.npy")),
                   np.load(os.path.join(rdir, "entity_state.npy")),
                   plan.per if vocab else None)

    def replicated(name, fname) -> EmbeddingState:
        return table(np.load(root + fname),
                     np.load(root + f"{name}_state.npy"))

    return TrainState(
        entity, replicated("relation", "relation.npy"),
        step=int(np.load(root + "step.npy")),
        projection=(replicated("projection", "projection.npy")
                    if model.is_transr else None))
