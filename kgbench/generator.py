"""The one generator of every traffic mix's triples, driven by parameters.

Triples follow the relation-block rule of the port's synthetic data
(``dglke_tpu_torch/data/dataset.py:synthetic_dataset``, copied here so that
the yardstick does not move with the program): each relation r draws its
heads from a block of ``block_span`` x (n_entities // n_relations)
entities starting at r's block, and each tail lies ``1 + r + u`` past its
head, u uniform in [0, tail_offsets).  Relations are thus uniform, and
entities near uniform: at FB15k's counts a batch of 1,000 triples holds
about 700 distinct relations, the most that 1,000 draws give.  The split
sizes are the configuration's.  Everything is drawn from ``seed`` with
numpy's default generator, so a seed gives the same triples on every
machine.
"""

from __future__ import annotations

import numpy as np

from kgbench.seeds import run_seed


def _relation_block(rng, n: int, n_ent: int, n_rel: int, span: int,
                    offsets: int):
    r = rng.integers(0, n_rel, n)
    block = max(1, n_ent // n_rel)
    h = (r * block + rng.integers(0, max(1, block * span), n)) % n_ent
    t = (h + r + 1 + rng.integers(0, offsets, n)) % n_ent
    return h.astype(np.int64), r.astype(np.int64), t.astype(np.int64)


def make_triples(config: dict, traffic: dict, seed: int) -> dict:
    """{split: (h, r, t) int64 arrays} for the splits ``traffic`` lists."""
    gen = traffic["generator"]
    n_ent, n_rel = config["n_entities"], config["n_relations"]
    seed = run_seed(seed)
    rng = np.random.default_rng([seed, 0x6B67])    # 'kg'
    out = {}
    for split in traffic["splits"]:
        out[split] = _relation_block(rng, config[f"n_{split}"], n_ent, n_rel,
                                     gen["block_span"], gen["tail_offsets"])
    return out
