"""Eval-side sampling (counterpart of dglke_tpu/data/sampler.py): the filter
index and the full-entity eval sampler.  Training batches are sampled on
the device (trainer.DevicePipeline), so there is no host train sampler."""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from dglke_tpu_torch.data.dataset import KGDataset


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


def _pad_bucket(n: int) -> int:
    """Pad filter-list width to a power-of-two bucket."""
    return max(8, 1 << (n - 1).bit_length())


class EvalSampler:
    """Batches of eval triples with padded filtered-id lists for
    full-entity ranking.

    mode: 'head' corrupts heads, 'tail' corrupts tails.  Yields dicts with
    h/r/t [B] int32, n_valid, neg_head, plus filter_ids/filter_mask [B, F]
    when filtering is on.  The tail batch is padded by repeating row 0;
    n_valid says how many rows are real."""

    def __init__(self, dataset: KGDataset, split: str, batch_size: int,
                 mode: str, filter_index: Optional[FilterIndex] = None,
                 eval_percent: float = 1.0, seed: int = 0):
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
        self.h, self.r, self.t = h[idx], r[idx], t[idx]
        self.batch_size = batch_size
        self.mode = mode
        self.filter = filter_index
        self.n = len(self.h)

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
            if self.filter is not None:
                ids, mask = self.filter.padded_lists(self.mode, h, r, t)
                out["filter_ids"] = ids
                out["filter_mask"] = mask
            yield out
