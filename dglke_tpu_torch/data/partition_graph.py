"""Offline graph partitioner for --dist training (counterpart of
dglke_tpu/data/partition_graph.py), writing the same artifacts, byte for
byte:

    partition_<p>/train.txt           local-id triples "src\\trel\\tdst"
    partition_<p>/local_to_global.txt one global node id per line
    partition_<p>/partition_book.txt  partition id of every global node
    partition_<p>/relation_count.txt  total number of relations

The default partitioner is LDG (Linear Deterministic Greedy) node
streaming: each node goes to the partition holding most of its neighbors,
discounted by partition fill, a one-pass approximation of min edge-cut.
``partition_and_write`` takes the native C++ form (data/native.py, a copy
of the JAX package's, whose default it is), so that both packages write
the same partitions from the same graph and seed.  ``ldg_partition`` is
the numpy form, kept as the plain version the tests read: its stream
order is numpy's permutation, not the C++ shuffle, so it assigns
differently.  ``random`` is the baseline.  Edges follow
their head node; tail endpoints outside the partition become halo nodes
(listed in local_to_global).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from dglke_tpu_torch.data.native import ldg_partition_native


def _build_csr(h: np.ndarray, t: np.ndarray, n_nodes: int):
    """Undirected adjacency in CSR form via sorting."""
    src = np.concatenate([h, t])
    dst = np.concatenate([t, h])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n_nodes), out=indptr[1:])
    return indptr, dst


def ldg_partition(h: np.ndarray, t: np.ndarray, n_nodes: int, k: int,
                  seed: int = 0) -> np.ndarray:
    """One-pass LDG, the numpy form: the partition id of every node.  A
    Python loop over the nodes, hours at Freebase's 86 M nodes; the
    partitioner takes data/native.py's form."""
    indptr, adj = _build_csr(h, t, n_nodes)
    order = np.random.RandomState(seed).permutation(n_nodes)
    assign = np.full(n_nodes, -1, np.int32)
    sizes = np.zeros(k, np.int64)
    capacity = max(1.0, n_nodes / k)
    for node in order:
        nbrs = adj[indptr[node]:indptr[node + 1]]
        placed = assign[nbrs] if len(nbrs) else np.empty(0, np.int32)
        placed = placed[placed >= 0]
        score = (np.bincount(placed, minlength=k).astype(np.float64)
                 if len(placed) else np.zeros(k))
        score *= 1.0 - sizes / capacity
        # break ties toward the emptiest partition
        p = int(np.argmax(score - 1e-9 * sizes))
        assign[node] = p
        sizes[p] += 1
    return assign


def random_node_partition(n_nodes: int, k: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, k, n_nodes).astype(np.int32)


def partition_and_write(triples: Tuple[np.ndarray, ...], n_entities: int,
                        n_relations: int, k: int, out_prefix: str,
                        method: str = "ldg", seed: int = 0) -> dict:
    """Partition the train graph and write the reference-format artifacts
    under ``{out_prefix}{p}/``.  Returns {"edge_cut": int, "assign":
    np.ndarray}.  ``ldg`` raises if the native library cannot be built."""
    h, r, t = (np.asarray(triples[i], np.int64) for i in range(3))
    if method == "ldg":
        # no fallback to the numpy form: it would write other partitions
        assign, _ = ldg_partition_native(h, t, n_entities, k, seed)
    elif method == "random":
        assign = random_node_partition(n_entities, k, seed)
    else:
        raise ValueError(f"unknown partition method {method}")

    edge_part = assign[h]  # an edge follows its head node
    edge_cut = int(np.sum(assign[h] != assign[t]))
    for p in range(k):
        pdir = f"{out_prefix}{p}"
        os.makedirs(pdir, exist_ok=True)
        mask = edge_part == p
        ph, pr, pt = h[mask], r[mask], t[mask]
        # local node set: inner nodes first, then halo endpoints
        inner = np.nonzero(assign == p)[0]
        halo = np.setdiff1d(np.unique(np.concatenate([ph, pt])), inner)
        local_nodes = np.concatenate([inner, halo])
        g2l = np.full(n_entities, -1, np.int64)
        g2l[local_nodes] = np.arange(len(local_nodes), dtype=np.int64)
        np.savetxt(os.path.join(pdir, "train.txt"),
                   np.stack([g2l[ph], pr, g2l[pt]], axis=1), fmt="%d",
                   delimiter="\t")
        np.savetxt(os.path.join(pdir, "local_to_global.txt"),
                   local_nodes[:, None], fmt="%d")
        with open(os.path.join(pdir, "relation_count.txt"), "w") as f:
            f.write(f"{n_relations}\n")
    for p in range(k):
        np.savetxt(os.path.join(f"{out_prefix}{p}", "partition_book.txt"),
                   np.asarray(assign)[:, None], fmt="%d")
    return {"edge_cut": edge_cut, "assign": assign}
