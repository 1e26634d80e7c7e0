"""Loading one rank's partition written by dglke_tpu_torch-partition (or
dglke_tpu-partition, the same layout; counterpart of
dglke_tpu/data/partition_dataset.py and the reference's
PartitionKGDataset): local-id triples, the local-to-global node map, the
global partition book and the relation count."""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class PartitionDataset:
    rank: int
    n_entities: int          # global entity count
    n_relations: int
    train: Tuple[np.ndarray, np.ndarray, np.ndarray]  # GLOBAL-id triples
    local_to_global: np.ndarray    # [n_local]
    partition_book: np.ndarray     # [n_entities] -> partition id

    @property
    def n_local(self) -> int:
        return len(self.local_to_global)


def load_partition(path: str, rank: int) -> PartitionDataset:
    """Partition ``rank`` under ``path`` (``partition_<rank>/``, or the flat
    ``<path><rank>`` the reference writes), its triples in global ids (the
    tables are indexed globally)."""
    pdir = os.path.join(path, f"partition_{rank}")
    if not os.path.isdir(pdir):
        pdir = path + str(rank)
    l2g = np.loadtxt(os.path.join(pdir, "local_to_global.txt"),
                     dtype=np.int64, ndmin=1)
    with open(os.path.join(pdir, "relation_count.txt")) as f:
        n_relations = int(f.readline().strip())
    book = np.loadtxt(os.path.join(pdir, "partition_book.txt"),
                      dtype=np.int64, ndmin=1)
    tri = np.loadtxt(os.path.join(pdir, "train.txt"), dtype=np.int64,
                     ndmin=2)
    if tri.size == 0:
        raise ValueError(
            f"partition {rank} ({pdir}) has no edges; repartition with a "
            f"smaller -k or a different method")
    h, r, t = tri[:, 0], tri[:, 1], tri[:, 2]
    return PartitionDataset(rank=rank, n_entities=len(book),
                            n_relations=n_relations,
                            train=(l2g[h], r, l2g[t]),
                            local_to_global=l2g, partition_book=book)
