"""Host-side sampling (counterpart of dglke_tpu/data/sampler.py): the
edge partitioners of --dist, the training sampler of the host-fed route,
the filter index and the eval sampler.

Most training batches are sampled on the device (trainer.DevicePipeline);
datasets smaller than two batches take the host-fed route, one
TrainSampler batch a step (trainer.HostFeed).  Eval batches rank against
every entity (filtered by padded true-entity lists) or, with
``neg_sample_size``, against a shared sample of negatives (the
reference's --neg_sample_size_eval protocol).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Optional

import numpy as np

from dglke_tpu_torch.data.dataset import KGDataset

# ---------------------------------------------------------------------------
# Edge partitioners (the reference's sampler.py:32-290; copies of the JAX
# package's, which give the same parts for the same edges)


def random_partition(triples, n_parts: int,
                     rng: Optional[np.random.RandomState] = None
                     ) -> List[np.ndarray]:
    """Shuffle edges, split into n_parts nearly equal index ranges."""
    n = len(triples[0])
    rng = rng or np.random.RandomState(0)
    perm = rng.permutation(n)
    part_size = math.ceil(n / n_parts)
    return [perm[i * part_size:(i + 1) * part_size] for i in range(n_parts)]


def balanced_relation_partition(triples, n_parts: int):
    """Each relation lives entirely in one part; parts greedily balanced by
    edge count (the reference's BalancedRelationPartition).

    Returns (edge_parts, rel_parts, cross_part=False)."""
    r = triples[1]
    uniq, counts = np.unique(r, return_counts=True)
    order = np.argsort(-counts)
    part_sizes = np.zeros(n_parts, np.int64)
    rel_parts: List[List[int]] = [[] for _ in range(n_parts)]
    assignment = np.zeros(int(uniq.max()) + 1 if len(uniq) else 1, np.int64)
    for idx in order:
        rel, cnt = uniq[idx], counts[idx]
        p = int(np.argmin(part_sizes))
        part_sizes[p] += cnt
        rel_parts[p].append(int(rel))
        assignment[rel] = p
    edge_part_of = assignment[r]
    edge_parts = [np.nonzero(edge_part_of == p)[0] for p in range(n_parts)]
    rel_parts = [np.asarray(sorted(rp), np.int64) for rp in rel_parts]
    return edge_parts, rel_parts, False


def soft_relation_partition(triples, n_parts: int, threshold: float = 0.05):
    """Relations with more than ``threshold`` of the per-part edge share
    are split across all parts ("cross" relations); the rest are pinned to
    one part, greedily balancing edge counts (the reference's
    SoftRelationPartition).

    Returns (edge_parts, rel_parts, cross_part, cross_rels)."""
    r = triples[1]
    n = len(r)
    uniq, counts = np.unique(r, return_counts=True)
    # cross iff count > min(threshold * E, E / n_parts)
    big = counts > min(threshold * n, n / n_parts)
    cross_rels = set(int(x) for x in uniq[big])

    part_sizes = np.zeros(n_parts, np.int64)
    rel_parts: List[List[int]] = [[] for _ in range(n_parts)]
    n_rel_max = int(uniq.max()) + 1 if len(uniq) else 1
    assignment = np.full(n_rel_max, -1, np.int64)
    for idx in np.argsort(-counts):
        rel, cnt = int(uniq[idx]), int(counts[idx])
        if rel in cross_rels:
            continue
        p = int(np.argmin(part_sizes))
        part_sizes[p] += cnt
        rel_parts[p].append(rel)
        assignment[rel] = p

    rng = np.random.RandomState(0)
    edge_parts: List[List[np.ndarray]] = [[] for _ in range(n_parts)]
    pinned = assignment[r]
    # pinned edges go to their relation's part
    for p in range(n_parts):
        edge_parts[p].append(np.nonzero(pinned == p)[0])
    # cross edges are spread to even out part sizes
    cross_idx = np.nonzero(pinned < 0)[0]
    rng.shuffle(cross_idx)
    sizes = np.array([len(e[0]) for e in edge_parts], np.int64)
    target = (n + n_parts - 1) // n_parts
    start = 0
    for p in range(n_parts):
        take = min(max(0, target - int(sizes[p])), len(cross_idx) - start)
        edge_parts[p].append(cross_idx[start:start + take])
        start += take
    # leftovers round-robin
    p = 0
    while start < len(cross_idx):
        edge_parts[p % n_parts].append(cross_idx[start:start + 1])
        start += 1
        p += 1
    edge_parts = [np.concatenate(e) for e in edge_parts]
    # every part also owns the cross relations
    rel_parts = [np.asarray(sorted(rp + list(cross_rels)), np.int64)
                 for rp in rel_parts]
    return edge_parts, rel_parts, len(cross_rels) > 0, sorted(cross_rels)


def partition_for_host(dataset: KGDataset, rank: int, n_parts: int,
                       rel_part: bool = False) -> KGDataset:
    """Rank ``rank``'s slice of the training edges, for --dist without
    offline partition artifacts: soft relation partitioning with
    ``rel_part`` (each relation pinned to one rank, heavy ones crossing),
    else a seeded random split.  Eval splits and id maps stay whole.
    Deterministic: every rank calls it with the same dataset and no
    coordination."""
    if n_parts <= 1:
        return dataset
    if rel_part:
        edge_parts = soft_relation_partition(dataset.train, n_parts)[0]
    else:
        edge_parts = random_partition(dataset.train, n_parts)
    idx = np.sort(edge_parts[rank])
    if len(idx) == 0:
        raise ValueError(
            f"host {rank}/{n_parts} received an empty edge partition "
            f"({dataset.n_train} train edges)")
    train = tuple(np.asarray(col)[idx] for col in dataset.train)
    return dataclasses.replace(dataset, train=train, train_partitioned=True)


# ---------------------------------------------------------------------------
# Training sampler


class TrainSampler:
    """Infinite sampler of chunked-negative batches over one edge partition.

    Equivalent to a (head, tail) pair of DGL EdgeSamplers wrapped in
    NewBidirectionalOneShotIterator: every call to ``next`` returns a batch
    alternating between head-corrupt and tail-corrupt negatives.
    """

    def __init__(self, dataset_or_triples, batch_size: int,
                 neg_sample_size: int, n_entities: Optional[int] = None,
                 edge_index: Optional[np.ndarray] = None, seed: int = 0,
                 shuffle: bool = True):
        if isinstance(dataset_or_triples, KGDataset):
            triples = dataset_or_triples.train
            n_entities = dataset_or_triples.n_entities
        else:
            triples = dataset_or_triples
            assert n_entities is not None
        self.h = np.ascontiguousarray(triples[0], np.int32)
        self.r = np.ascontiguousarray(triples[1], np.int32)
        self.t = np.ascontiguousarray(triples[2], np.int32)
        self.impts = (np.ascontiguousarray(triples[3], np.float32)
                      if len(triples) == 4 else None)
        if edge_index is not None:
            self.h = self.h[edge_index]
            self.r = self.r[edge_index]
            self.t = self.t[edge_index]
            if self.impts is not None:
                self.impts = self.impts[edge_index]
        self.n_edges = len(self.h)
        self.n_entities = n_entities
        self.batch_size = batch_size
        self.neg_sample_size = neg_sample_size
        self.chunk_size = (neg_sample_size if neg_sample_size < batch_size
                           else batch_size)
        self.num_chunks = max(1, batch_size // self.chunk_size)
        assert batch_size % self.chunk_size == 0, \
            "batch_size must be divisible by neg_sample_size"
        self.rng = np.random.RandomState(seed)
        self.shuffle = shuffle
        self._perm = None
        self._pos = 0
        self._neg_head = True  # alternates

    def _refill(self):
        self._perm = (self.rng.permutation(self.n_edges) if self.shuffle
                      else np.arange(self.n_edges))
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        b = self.batch_size
        if self._perm is None or self._pos + b > len(self._perm):
            self._refill()
            # partitions smaller than a batch wrap around
            while len(self._perm) < b:
                self._perm = np.concatenate(
                    [self._perm, self.rng.permutation(self.n_edges)])
        idx = self._perm[self._pos:self._pos + b]
        self._pos += b
        neg = self.rng.randint(
            0, self.n_entities,
            self.num_chunks * self.neg_sample_size).astype(np.int32)
        neg_head = self._neg_head
        self._neg_head = not self._neg_head
        batch = {
            "h": self.h[idx], "r": self.r[idx], "t": self.t[idx],
            "neg": neg, "neg_head": neg_head,
            "impts": self.impts[idx] if self.impts is not None else None,
        }
        return batch


class FilterIndex:
    """Sorted-key lookup of all true (h,r)->tails and (r,t)->heads over
    train+valid+test: two sorted numpy arrays + searchsorted."""

    def __init__(self, dataset: KGDataset):
        splits = [s for s in (dataset.train, dataset.valid, dataset.test)
                  if s is not None]
        h = np.concatenate([s[0] for s in splits]).astype(np.int64)
        r = np.concatenate([s[1] for s in splits]).astype(np.int64)
        t = np.concatenate([s[2] for s in splits]).astype(np.int64)
        nr = dataset.n_relations

        # Secondary sort by value id so each key's list is itself sorted.
        # Duplicate (key, value) pairs (the same triple in several splits)
        # are dropped: the full-ranking eval SUBTRACTS the filtered count
        # from the total, so a duplicate would be subtracted twice.
        def _sorted_unique(keys, vals):
            order = np.lexsort((vals, keys))
            keys, vals = keys[order], vals[order]
            if len(keys):
                fresh = np.empty(len(keys), bool)
                fresh[0] = True
                np.logical_or(keys[1:] != keys[:-1],
                              vals[1:] != vals[:-1], out=fresh[1:])
                keys, vals = keys[fresh], vals[fresh]
            return keys, vals.astype(np.int32)

        self._hr_keys, self._hr_tails = _sorted_unique(h * nr + r, t)
        self._tr_keys, self._tr_heads = _sorted_unique(t * nr + r, h)
        self._nr = nr
        self._ne = dataset.n_entities

    def true_tails(self, h: int, r: int) -> np.ndarray:
        k = h * self._nr + r
        lo = np.searchsorted(self._hr_keys, k, "left")
        hi = np.searchsorted(self._hr_keys, k, "right")
        return self._hr_tails[lo:hi]

    def true_heads(self, r: int, t: int) -> np.ndarray:
        k = t * self._nr + r
        lo = np.searchsorted(self._tr_keys, k, "left")
        hi = np.searchsorted(self._tr_keys, k, "right")
        return self._tr_heads[lo:hi]

    def _bounds(self, mode: str, h, r, t):
        """(values, lo [B], hi [B]) where values[lo[i]:hi[i]] are row i's
        true heads (mode='head') or tails."""
        if mode == "head":
            keys, values = self._tr_keys, self._tr_heads
            q = np.asarray(t, np.int64) * self._nr + np.asarray(r, np.int64)
        else:
            keys, values = self._hr_keys, self._hr_tails
            q = np.asarray(h, np.int64) * self._nr + np.asarray(r, np.int64)
        return (values, np.searchsorted(keys, q, "left"),
                np.searchsorted(keys, q, "right"))

    def padded_lists(self, mode: str, h, r, t, pad_width=None):
        """Padded per-row true-entity lists for a whole batch in one
        vectorized pass: (ids [B, F] int32, mask [B, F] uint8)."""
        values, lo, hi = self._bounds(mode, h, r, t)
        widths = hi - lo
        f = pad_width or _pad_bucket(max(1, int(widths.max(initial=0))))
        idx = lo[:, None] + np.arange(f)[None, :]
        vals = values[np.minimum(idx, len(values) - 1)]
        keep = np.arange(f)[None, :] < widths[:, None]
        return (np.where(keep, vals, 0).astype(np.int32),
                keep.astype(np.uint8))

    def false_neg_mask(self, mode: str, h, r, t, neg: np.ndarray):
        """[B, K] uint8 keep-mask over the shared negative candidates `neg`:
        0 where neg_j forms a true triple with row i (a false negative to
        exclude from ranking), 1 otherwise; consumers compare `> 0`.

        One searchsorted answers every (row, neg) query: each row's list is
        value-sorted, so padding the rows to the batch's widest with an
        out-of-range sentinel (n_entities) and offsetting row i into its
        own block [i*stride, (i+1)*stride) gives one sorted flat array."""
        values, lo, hi = self._bounds(mode, h, r, t)
        widths = hi - lo
        b, k = len(lo), len(neg)
        f = max(1, int(widths.max(initial=0)))
        idx = lo[:, None] + np.arange(f)[None, :]
        vals = values[np.minimum(idx, max(len(values) - 1, 0))].astype(
            np.int64) if len(values) else np.zeros((b, f), np.int64)
        pad = np.arange(f)[None, :] >= widths[:, None]
        vals[pad] = self._ne
        stride = np.int64(self._ne) + 1
        rows = np.arange(b, dtype=np.int64)[:, None] * stride
        flat = (vals + rows).ravel()
        q = (neg.astype(np.int64)[None, :] + rows).ravel()
        pos = np.searchsorted(flat, q)
        member = (pos < flat.size) & (flat[np.minimum(pos, flat.size - 1)]
                                      == q)
        keep = np.ones(b * k, np.uint8)
        keep[member] = 0
        return keep.reshape(b, k)


def _pad_bucket(n: int) -> int:
    """Pad filter-list width to a power-of-two bucket."""
    return max(8, 1 << (n - 1).bit_length())


class EvalSampler:
    """Batches of eval triples.

    mode: 'head' corrupts heads, 'tail' corrupts tails; (rank, ranks)
    strides the split.  Yields dicts with h/r/t [B] int32, n_valid,
    neg_head, plus filter_ids/filter_mask [B, F] when filtering is on.  The
    tail batch is padded by repeating row 0; n_valid says how many rows
    are real.

    0 < neg_sample_size < n_entities selects sampled-negative eval (the
    reference's --neg_sample_size_eval protocol): each batch carries `neg`
    [K], one shared uniform draw for the whole batch, and `neg_deg_sample`;
    with filtering, `neg_keep` [B, K] in place of the filter lists.
    neg_deg_sample adds the batch's own corrupted-side entities as extra
    candidates downstream; it requires filtering off, as the reference
    asserts.
    """

    def __init__(self, dataset: KGDataset, split: str, batch_size: int,
                 mode: str, filter_index: Optional[FilterIndex] = None,
                 eval_percent: float = 1.0, rank: int = 0, ranks: int = 1,
                 seed: int = 0, neg_sample_size: int = -1,
                 neg_deg_sample: bool = False):
        triples = getattr(dataset, split)
        if triples is None:
            raise ValueError(f"dataset has no {split} split")
        h, r, t = (np.asarray(triples[0], np.int64),
                   np.asarray(triples[1], np.int64),
                   np.asarray(triples[2], np.int64))
        n = len(h)
        idx = np.arange(n)
        if eval_percent < 1.0:
            rng = np.random.RandomState(seed)
            idx = np.sort(rng.permutation(n)[:max(1, int(n * eval_percent))])
        idx = idx[rank::ranks]
        self.h, self.r, self.t = h[idx], r[idx], t[idx]
        self.batch_size = batch_size
        self.mode = mode
        self.filter = filter_index
        self.n = len(self.h)
        self.n_entities = dataset.n_entities
        k = neg_sample_size if neg_sample_size is not None else -1
        self.neg_sample_size = k if 0 < k < self.n_entities else 0
        self.neg_deg_sample = neg_deg_sample
        if neg_deg_sample and filter_index is not None:
            raise ValueError("neg_deg_sample_eval requires --no_eval_filter")
        if neg_deg_sample and self.neg_sample_size == 0:
            raise ValueError(
                "neg_deg_sample_eval needs sampled negatives: set "
                "--neg_sample_size_eval < n_entities")
        # distinct per (rank, mode), the JAX package's formula, so that
        # both packages draw the same negatives for the same seed
        self._rng = np.random.RandomState(
            (seed + 7919 * rank + (0 if mode == "head" else 104729))
            % (2**31 - 1))

    def __len__(self):
        return -(-self.n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        b = self.batch_size
        for start in range(0, self.n, b):
            h = self.h[start:start + b]
            r = self.r[start:start + b]
            t = self.t[start:start + b]
            nb = len(h)
            if nb < b:
                pad = b - nb
                h = np.concatenate([h, np.repeat(h[:1], pad)])
                r = np.concatenate([r, np.repeat(r[:1], pad)])
                t = np.concatenate([t, np.repeat(t[:1], pad)])
            out = {
                "h": h.astype(np.int32), "r": r.astype(np.int32),
                "t": t.astype(np.int32), "n_valid": nb,
                "neg_head": self.mode == "head",
            }
            if self.neg_sample_size > 0:
                neg = self._rng.randint(
                    0, self.n_entities, self.neg_sample_size
                ).astype(np.int32)
                out["neg"] = neg
                out["neg_deg_sample"] = self.neg_deg_sample
                if self.filter is not None:
                    out["neg_keep"] = self.filter.false_neg_mask(
                        self.mode, h, r, t, neg)
            elif self.filter is not None:
                ids, mask = self.filter.padded_lists(self.mode, h, r, t)
                out["filter_ids"] = ids
                out["filter_mask"] = mask
            yield out
