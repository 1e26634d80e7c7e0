"""What the port's device pipeline draws from its seed, worked out again:
the initial tables, the epoch permutations and each step's negatives.

The rules follow the program's documented streams (``DevicePipeline``):
tables uniform in (-range, range), each at the range its family declares
(``emb_init``; TransR's projection 1.0), the entity table, the relation
table, then any further table, from one generator on the card seeded
with the run's seed; epoch e's permutation is ``randperm`` under a
generator seeded from (seed, 'perm', e); step i's negatives are one
``randint`` under a generator seeded from (seed, 'negS', i); step i
corrupts heads when i is even; a step takes the next ``batch_size``
positions of the permutations laid end to end.
"""

from __future__ import annotations

import numpy as np
import torch

PERM_TAG = 0x7065726D    # 'perm'
NEG_TAG = 0x6E656753     # 'negS'


def stream_seed(*words: int) -> int:
    """A 64-bit generator seed hashed from integer words."""
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


def table_shapes(family, config: dict) -> list:
    """[(rows, width, init range)] of every table of ``family`` (its
    module's ``tables(hidden, emb_init)``) in draw order: entity rows
    first, ``n_relations`` rows for every further table."""
    hidden = config["flags"]["hidden_dim"]
    declared = family.tables(hidden, (config["flags"]["gamma"] + 2.0) / hidden)
    rows = [config["n_entities"]] + [config["n_relations"]] * (
        len(declared) - 1)
    return [(n, width, init) for n, (width, init) in zip(rows, declared)]


def init_tables(seed: int, shapes, device):
    """The initial tables of ``shapes`` [(rows, width, init range), ...]
    in draw order, fp32."""
    gen = torch.Generator(device)
    gen.manual_seed(seed)
    out = []
    for rows, width, init in shapes:
        emb = torch.empty((rows, width), dtype=torch.float32, device=device)
        emb.uniform_(-init, init, generator=gen)
        out.append(emb)
    return out


def permutation(seed: int, epoch: int, n: int, device) -> torch.Tensor:
    gen = torch.Generator(device)
    gen.manual_seed(stream_seed(seed, PERM_TAG, epoch))
    return torch.randperm(n, generator=gen, device=device)


def negatives(seed: int, step: int, n_entities: int, count: int,
              device) -> torch.Tensor:
    gen = torch.Generator(device)
    gen.manual_seed(stream_seed(seed, NEG_TAG, step))
    return torch.randint(0, n_entities, (count,), generator=gen,
                         device=device, dtype=torch.int32)


class Batches:
    """The batches of steps ``first``, ``first + 1``, ... over ``triples``
    [3, n] on the card: (h, r, t, neg, neg_head) each."""

    def __init__(self, seed: int, triples: torch.Tensor, batch: int,
                 neg_total: int, n_entities: int):
        self.seed, self.triples, self.b = seed, triples, batch
        self.neg_total, self.n_entities = neg_total, n_entities
        self.n = triples.shape[1]
        self._perms: dict = {}

    def _perm(self, epoch: int) -> torch.Tensor:
        if epoch not in self._perms:
            self._perms = {e: p for e, p in self._perms.items()
                           if e >= epoch - 1}
            self._perms[epoch] = permutation(self.seed, epoch, self.n,
                                             self.triples.device)
        return self._perms[epoch]

    def edge_ids(self, step: int) -> torch.Tensor:
        start = step * self.b
        first, last = start // self.n, (start + self.b - 1) // self.n
        ids = torch.cat([self._perm(e) for e in range(first, last + 1)])
        at = start - first * self.n
        return ids[at:at + self.b]

    def __call__(self, step: int):
        h, r, t = self.triples[:, self.edge_ids(step)]
        neg = negatives(self.seed, step, self.n_entities, self.neg_total,
                        self.triples.device)
        return h, r, t, neg, step % 2 == 0
