"""The process group of a --dist run and the sharding plans (counterpart
of dglke_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a device mesh.  Here each rank
is one process with one device under torch.distributed, and a
``ShardingPlan`` says where each table lives and how a step's rows reach
it:

  * ``table_sharding="replicated"``: every rank holds the whole tables.  A
    step gathers its own rows (K1), scales its loss by its share of the
    global batch, all-gathers its (ids, gradient rows) in rank order and
    runs K2 over that global list on its own replica, so every replica
    takes the same update in the same order and stays bit-identical.
  * ``table_sharding="vocab"``: the entity table and its Adagrad state
    are cut into contiguous ranges of ``per = ceil(N / n)`` rows, the last
    one zero-padded (mesh.py:90-105 of the JAX package); padded rows are
    never referenced.  A gather routes each id to its owner
    (``id // per``) through a fixed-capacity exchange, computed on the
    device only, so that a CUDA graph can hold it (XLA gives the JAX
    package's gather static shapes the same way): a rank of N ids sends
    each rank a block of C = N slots, the worst case, so no id ever
    overflows and nothing is decided on the host.  An id's slot in its
    owner's block is its stable rank among this rank's ids of that owner;
    the rest of a block is pad slots, local id 0.  The owner runs K1 on
    all n * C local ids it receives, the rows go back along the same
    blocks, and each id takes its own slot's row (pad rows are dropped).
    The update runs the same route backwards: each owner receives (local
    id, gradient row) in (source rank, position) order, the pad slots
    with zero rows, and runs K2 on all n * C of them: a zero row at an
    in-range id leaves that row and its state_sum bit-equal.  Ids travel
    as they come, duplicates included, so K2 sums every occurrence in a
    fixed order as on one device; at n = 1 the route hands K1 and K2 one
    device's ids in one device's order.  The cost: n x the bytes of an
    exchange sized to each owner's own count, and an owner's K1 and K2
    over n * C ids.
    Relation tables and TransR's projection table stay replicated
    (mesh.py:65-74) and take the replicated route.

Only batch-sized tensors cross ranks (collectives.Comm counts them).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from dglke_tpu_torch.device import rank_device
from dglke_tpu_torch.parallel.collectives import Comm

TABLE_SHARDINGS = ("replicated", "vocab")
DIST_VARIABLES = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
# How long a rank waits in a collective for the others before it fails
# (a dead rank must not wedge the rest for ever).
DEFAULT_TIMEOUT_S = 900

# Domain tags of the vocab plan's initial draw (see ShardingPlan.init_state)
_ENT_TAG = 0x656E7453     # 'entS'
_REL_TAG = 0x72656C53     # 'relS'


@dataclasses.dataclass(frozen=True)
class DistEnv:
    """torch's launcher variables: MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE, LOCAL_RANK and LOCAL_WORLD_SIZE (the last two default to
    RANK and WORLD_SIZE: every rank on this host)."""
    master_addr: str
    master_port: int
    rank: int
    world: int
    local_rank: int
    local_world: int

    @classmethod
    def from_environ(cls, environ=None) -> "DistEnv":
        env = os.environ if environ is None else environ
        missing = [k for k in DIST_VARIABLES if k not in env]
        if missing:
            raise SystemExit(
                f"--dist needs the launcher variables {', '.join(missing)} "
                f"(torchrun and dglke_tpu_torch-dist_train set them)")
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        if not 0 <= rank < world:
            raise SystemExit(f"RANK {rank} outside WORLD_SIZE {world}")
        return cls(env["MASTER_ADDR"], int(env["MASTER_PORT"]), rank, world,
                   int(env.get("LOCAL_RANK", rank)),
                   int(env.get("LOCAL_WORLD_SIZE", world)))


def choose_layout(device: str, local_rank: int, local_world: int):
    """(the rank's device, the backend, a description of the layout).

    On the CPU: gloo.  On cards: the rank's card is
    cuda:{LOCAL_RANK % device_count}; NCCL when each of this host's ranks
    has a card of its own, gloo (host-staged) when ranks share one.
    Raises without a card unless the CPU is asked for."""
    dev = rank_device(device, local_rank)
    if dev.type == "cpu":
        return dev, "gloo", f"{local_world} rank(s) on the CPU"
    n_cards = torch.cuda.device_count()
    if local_world <= n_cards:
        return dev, "nccl", "one card a rank"
    sharing = sum(1 for r in range(local_world) if r % n_cards == dev.index)
    return dev, "gloo", f"{sharing} ranks share {dev}"


def init_distributed(device: str = "cuda", environ=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> Comm:
    """Start this rank's process group from the launcher variables, on the
    device and backend ``choose_layout`` decides (once, before the group
    starts; nothing falls back to another)."""
    import torch.distributed as dist

    env = DistEnv.from_environ(environ)
    dev, backend, layout = choose_layout(device, env.local_rank,
                                         env.local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=f"tcp://{env.master_addr}:{env.master_port}",
        rank=env.rank, world_size=env.world,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return Comm(env.rank, env.world, dev, backend, layout)


class Route(NamedTuple):
    """How one routed gather moved its ids, on the device: ``slot`` [N]
    is each id's slot in the [n * C] blocks it sent (owner * C + its
    stable rank among the ids of that owner, C = N), ``recv_ids`` [n * C]
    the local ids this rank received for its shard (in source rank,
    position order; pad slots 0).  The update of the same ids reuses it."""
    slot: torch.Tensor
    recv_ids: torch.Tensor


class ShardingPlan:
    """Where the tables of a --dist run live, and the collectives that move
    a step's rows (see the module docstring)."""

    def __init__(self, comm: Comm, table_sharding: str, n_entities: int):
        if table_sharding not in TABLE_SHARDINGS:
            raise ValueError(f"unknown table_sharding {table_sharding!r}; "
                             f"use one of {TABLE_SHARDINGS}")
        self.comm = comm
        self.table_sharding = table_sharding
        self.n_entities = n_entities
        self.n = comm.world
        self.rank = comm.rank
        self.per = (math.ceil(n_entities / self.n) if self.vocab
                    else n_entities)
        self.lo = self.rank * self.per if self.vocab else 0

    @property
    def vocab(self) -> bool:
        return self.table_sharding == "vocab"

    @property
    def device(self) -> torch.device:
        return self.comm.device

    @property
    def n_real(self) -> int:
        """Entity rows of this rank's shard that exist (the rest pad)."""
        return max(0, min(self.per, self.n_entities - self.lo))

    def describe(self) -> str:
        return (f"Using {self.n}-rank mesh (tables: {self.table_sharding}; "
                f"backend {self.comm.backend}: {self.comm.layout})")

    # -- state ---------------------------------------------------------------

    def shard_rows(self, arr):
        """This rank's rows of an entity-indexed array (a numpy array or
        memmap, or a tensor), zero-padded to ``per`` rows; the whole array
        under the replicated plan."""
        if not self.vocab:
            return arr
        part = arr[self.lo:self.lo + self.n_real]
        pad = self.per - part.shape[0]
        if not pad:
            return part
        if isinstance(part, torch.Tensor):
            return torch.cat([part, part.new_zeros(
                (pad,) + tuple(part.shape[1:]))])
        return np.concatenate([np.asarray(part), np.zeros(
            (pad,) + part.shape[1:], part.dtype)])

    def shard_state(self, state):
        """This rank's part of a whole TrainState (the entity table and its
        state_sum cut to the shard, the rest as it is)."""
        from dglke_tpu_torch.models.ke_model import TrainState
        from dglke_tpu_torch.ops.embedding import EmbeddingState
        if not self.vocab:
            return state
        ent = EmbeddingState(self.shard_rows(state.entity.emb).contiguous(),
                             self.shard_rows(
                                 state.entity.state_sum).contiguous())
        return TrainState(ent, state.relation, step=state.step,
                          projection=state.projection)

    def init_state(self, model):
        """Fresh tables for this rank.  Replicated: the single-device draw
        from config.seed on every rank.  Vocab with one rank: the same.
        Vocab over n ranks: each rank draws only its own entity rows, from
        a stream of (seed, n, rank); the replicated tables from a stream of
        (seed, n), the same on every rank.  Deterministic given (seed, n);
        not the single-device table."""
        from dglke_tpu_torch.models.ke_model import TrainState
        from dglke_tpu_torch.ops.embedding import EmbeddingState, \
            init_embedding
        from dglke_tpu_torch.trainer import _stream_seed
        if not self.vocab or self.n == 1:
            return model.init_state()
        cfg, dev = model.config, model.device
        gen = torch.Generator(dev)
        gen.manual_seed(_stream_seed(cfg.seed, _ENT_TAG, self.n, self.rank))
        real = init_embedding(gen, self.n_real, model.entity_dim,
                              cfg.emb_init, model.table_dtype, dev)
        emb = torch.zeros((self.per, model.entity_dim),
                          dtype=model.table_dtype, device=dev)
        emb[:self.n_real] = real.emb
        entity = EmbeddingState(emb, torch.zeros(
            (self.per,), dtype=torch.float32, device=dev))
        gen.manual_seed(_stream_seed(cfg.seed, _REL_TAG, self.n))
        relation = init_embedding(gen, model.n_relations, model.relation_dim,
                                  cfg.emb_init, model.table_dtype, dev)
        projection = None
        if model.is_transr:
            projection = init_embedding(gen, model.n_relations,
                                        model.proj_dim, 1.0,
                                        model.table_dtype, dev)
        return TrainState(entity, relation, projection=projection)

    # -- the routed entity table (vocab) -------------------------------------

    def routed_gather(self, table, ids: torch.Tensor, dim: int):
        """fp32 rows [N, dim] of the sharded entity table at global ``ids``
        [N], in the ids' order, and the Route that moved them.  Each owner
        runs K1 on its shard over all n * N slots it receives."""
        from dglke_tpu_torch.ops import rows as row_ops
        m = ids.shape[0]
        ids64 = ids.to(torch.int64)
        owner = torch.div(ids64, self.per, rounding_mode="floor")
        # each id's stable rank among the ids of its owner: a running
        # count of the owners seen so far, one column a rank
        seen = torch.cumsum(owner[:, None] == torch.arange(
            self.n, device=ids.device)[None, :], dim=0)
        slot = owner * m + seen.gather(1, owner[:, None])[:, 0] - 1
        send = torch.zeros(self.n * m, dtype=torch.int32, device=ids.device)
        send[slot] = (ids64 - owner * self.per).to(torch.int32)
        recv_ids = self.comm.exchange(send)
        served = row_ops.gather_rows(table.emb, recv_ids, dim)
        return self.comm.exchange(served)[slot], Route(slot, recv_ids)

    def routed_update(self, table, route: Route, grads: torch.Tensor,
                      lr: float) -> None:
        """Row-sparse Adagrad of the gradient rows of a routed gather's ids,
        IN PLACE on this rank's shard: the rows go to their owners along
        the route (zero rows in the pad slots), and each owner runs K2 on
        all n * N slots it receives."""
        from dglke_tpu_torch.ops.embedding import sparse_adagrad_update
        send = grads.new_zeros((route.recv_ids.shape[0], grads.shape[1]))
        send[route.slot] = grads
        sparse_adagrad_update(table, route.recv_ids,
                              self.comm.exchange(send), lr)

    # -- replicated tables ---------------------------------------------------

    def allgather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` in rank order (the global batch's layout)."""
        return self.comm.all_gather(x)

    def allgather_update(self, table, ids: torch.Tensor,
                         grads: torch.Tensor, lr: float) -> None:
        """Row-sparse Adagrad of every rank's (ids, gradient rows), in rank
        order, IN PLACE on this rank's replica (K2): every replica takes the
        same update in the same order."""
        from dglke_tpu_torch.ops.embedding import sparse_adagrad_update
        sparse_adagrad_update(table, self.allgather(ids),
                              self.allgather(grads), lr)

    def allreduce_counts(self, counts: torch.Tensor) -> torch.Tensor:
        return self.comm.all_reduce(counts)
