"""Knowledge-graph dataset loading (counterpart of dglke_tpu/data/dataset.py).

Covers the layouts the single-device trainer reads:

  * built-in datasets (FB15k, FB15k-237, wn18, wn18rr) in the
    entities.dict/relations.dict + name-triple layout, and the Freebase
    layout (count-only headers, integer triples in h-t-r column order);
  * user-defined pre-mapped datasets ``udd_{hrt-permutation}``;
  * raw user-defined datasets ``raw_udd_{permutation}`` (string triples; the
    loader builds id maps and writes entities.tsv / relations.tsv);
  * custom delimiters and an optional 4th edge-importance column.

Built-in datasets are read from ``data_path``; this package downloads
nothing.  Synthetic and planted-structure generators for tests and the
chip smoke run live here too.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

Triples = Tuple[np.ndarray, ...]  # (h, r, t) or (h, r, t, impts)


def _parse_hrt_format(fmt: str) -> List[int]:
    """'hrt' -> column positions of [head, rel, tail] in a data row."""
    perms = {
        "hrt": [0, 1, 2], "htr": [0, 2, 1], "rht": [1, 0, 2],
        "rth": [2, 0, 1], "thr": [1, 2, 0], "trh": [2, 1, 0],
    }
    if fmt not in perms:
        raise ValueError(f"unknown triple format {fmt!r}")
    return perms[fmt]


@dataclasses.dataclass
class KGDataset:
    name: str
    n_entities: int
    n_relations: int
    train: Triples
    valid: Optional[Triples] = None
    test: Optional[Triples] = None
    entity2id: Optional[Dict[str, int]] = None
    relation2id: Optional[Dict[str, int]] = None
    emap_fname: Optional[str] = None
    rmap_fname: Optional[str] = None

    @property
    def has_edge_importance(self) -> bool:
        return len(self.train) == 4

    @property
    def n_train(self) -> int:
        return len(self.train[0])


# ---------------------------------------------------------------------------
# File readers


def _read_id_map(path: str, delimiter: str = "\t") -> Dict[str, int]:
    """'id<delim>name' lines (built-in .dict files)."""
    out: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            a, b = line.split(delimiter)
            out[b] = int(a)
    return out


def _read_name_triples(path: str, entity2id, relation2id, fmt: List[int],
                       delimiter: str = "\t",
                       has_importance: bool = False) -> Triples:
    heads, rels, tails, impts = [], [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            cols = line.split(delimiter)
            heads.append(entity2id[cols[fmt[0]]])
            rels.append(relation2id[cols[fmt[1]]])
            tails.append(entity2id[cols[fmt[2]]])
            if has_importance:
                impts.append(float(cols[3]))
    out = (np.asarray(heads, np.int64), np.asarray(rels, np.int64),
           np.asarray(tails, np.int64))
    if has_importance:
        return out + (_positive_weights(impts),)
    return out


def _read_int_triples(path: str, fmt: List[int], delimiter: str = "\t",
                      has_importance: bool = False) -> Triples:
    cols_data: List[List] = [[], [], [], []]
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            cols = line.split(delimiter)
            try:
                cols_data[0].append(int(cols[fmt[0]]))
                cols_data[1].append(int(cols[fmt[1]]))
                cols_data[2].append(int(cols[fmt[2]]))
            except ValueError:
                raise ValueError(
                    "For a user-defined dataset, node ids and relation ids in "
                    f"the triples must be integers, got {cols!r}")
            if has_importance:
                cols_data[3].append(float(cols[3]))
    out = (np.asarray(cols_data[0], np.int64),
           np.asarray(cols_data[1], np.int64),
           np.asarray(cols_data[2], np.int64))
    if has_importance:
        return out + (_positive_weights(cols_data[3]),)
    return out


def _positive_weights(values) -> np.ndarray:
    e = np.asarray(values, np.float32)
    if len(e) and e.min() <= 0.0:
        raise ValueError("edge importance weights must be positive")
    return e


def _check_ranges(ds: KGDataset) -> KGDataset:
    for split in (ds.train, ds.valid, ds.test):
        if split is None or len(split[0]) == 0:
            continue
        h, r, t = split[0], split[1], split[2]
        if not (0 <= h.min() and h.max() < ds.n_entities):
            raise ValueError("Head node ID out of range")
        if not (0 <= t.min() and t.max() < ds.n_entities):
            raise ValueError("Tail node ID out of range")
        if not (0 <= r.min() and r.max() < ds.n_relations):
            raise ValueError("Relation ID out of range")
    return ds


# ---------------------------------------------------------------------------
# Built-in layouts


def load_builtin(data_path: str, name: str) -> KGDataset:
    path = os.path.join(data_path, name)
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"Built-in dataset {name} not found at {path}: place the "
            "standard layout (entities.dict, relations.dict, train.txt, "
            "valid.txt, test.txt) there")
    if name == "Freebase":
        return _load_freebase(path)
    e2i = _read_id_map(os.path.join(path, "entities.dict"))
    r2i = _read_id_map(os.path.join(path, "relations.dict"))
    splits = {}
    for split in ("train", "valid", "test"):
        p = os.path.join(path, f"{split}.txt")
        splits[split] = (_read_name_triples(p, e2i, r2i, [0, 1, 2])
                         if os.path.exists(p) else None)
    return _check_ranges(KGDataset(
        name=name, n_entities=len(e2i), n_relations=len(r2i),
        train=splits["train"], valid=splits["valid"], test=splits["test"],
        entity2id=e2i, relation2id=r2i,
        emap_fname="entities.dict", rmap_fname="relations.dict"))


def _load_freebase(path: str) -> KGDataset:
    """Freebase-86M layout: entity2id.txt / relation2id.txt carry a
    count-only first line; triples are integer rows in h-t-r order."""
    with open(os.path.join(path, "entity2id.txt")) as f:
        n_entities = int(f.readline().strip())
    with open(os.path.join(path, "relation2id.txt")) as f:
        n_relations = int(f.readline().strip())
    splits = {}
    for split in ("train", "valid", "test"):
        p = os.path.join(path, f"{split}.txt")
        splits[split] = (_read_int_triples(p, [0, 2, 1])
                         if os.path.exists(p) else None)
    return _check_ranges(KGDataset(
        name="Freebase", n_entities=n_entities, n_relations=n_relations,
        train=splits["train"], valid=splits["valid"], test=splits["test"],
        emap_fname="entity2id.txt", rmap_fname="relation2id.txt"))


# ---------------------------------------------------------------------------
# User-defined datasets


def load_udd(data_path: str, name: str, delimiter: str, files: List[str],
             fmt: str, has_edge_importance: bool = False) -> KGDataset:
    """Pre-mapped integer triples. files = [entity2id, relation2id, train
    [, valid, test]]."""
    if files is None or len(files) not in (3, 5):
        raise ValueError(
            "udd_{htr} format requires 3 or 5 input files: entity2id, "
            "relation2id, train_file [, valid_file, test_file]")
    positions = _parse_hrt_format(fmt)

    def count_lines(p):
        with open(p) as f:
            return sum(1 for _ in f)

    def read(p):
        return _read_int_triples(os.path.join(data_path, p), positions,
                                 delimiter, has_importance=has_edge_importance)

    n_entities = count_lines(os.path.join(data_path, files[0]))
    n_relations = count_lines(os.path.join(data_path, files[1]))
    valid = read(files[3]) if len(files) == 5 else None
    test = read(files[4]) if len(files) == 5 else None
    return _check_ranges(KGDataset(
        name=name, n_entities=n_entities, n_relations=n_relations,
        train=read(files[2]), valid=valid, test=test,
        emap_fname=files[0], rmap_fname=files[1]))


def load_raw_udd(data_path: str, name: str, delimiter: str,
                 files: List[str], fmt: str,
                 has_edge_importance: bool = False) -> KGDataset:
    """String triples; builds id maps over all provided files in order of
    first appearance and writes entities.tsv / relations.tsv."""
    if files is None or len(files) not in (1, 3):
        raise ValueError(
            "raw_udd_{htr} format requires 1 or 3 input files: train_file "
            "[, valid_file, test_file]")
    positions = _parse_hrt_format(fmt)
    entity2id: Dict[str, int] = {}
    relation2id: Dict[str, int] = {}

    def get_id(m, k):
        if k not in m:
            m[k] = len(m)
        return m[k]

    for fi in files:
        with open(os.path.join(data_path, fi)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                cols = line.split(delimiter)
                get_id(entity2id, cols[positions[0]])
                get_id(relation2id, cols[positions[1]])
                get_id(entity2id, cols[positions[2]])

    with open(os.path.join(data_path, "entities.tsv"), "w") as f:
        f.writelines(f"{v}{delimiter}{k}\n" for k, v in entity2id.items())
    with open(os.path.join(data_path, "relations.tsv"), "w") as f:
        f.writelines(f"{v}{delimiter}{k}\n" for k, v in relation2id.items())

    def read(p):
        return _read_name_triples(os.path.join(data_path, p), entity2id,
                                  relation2id, positions, delimiter,
                                  has_importance=has_edge_importance)

    return KGDataset(name=name, n_entities=len(entity2id),
                     n_relations=len(relation2id), train=read(files[0]),
                     valid=read(files[1]) if len(files) == 3 else None,
                     test=read(files[2]) if len(files) == 3 else None,
                     entity2id=entity2id, relation2id=relation2id,
                     emap_fname="entities.tsv", rmap_fname="relations.tsv")


def get_dataset(data_path: str, data_name: str, format_str: str,
                delimiter: str = "\t", files: Optional[List[str]] = None,
                has_edge_importance: bool = False) -> KGDataset:
    if format_str == "built_in":
        if data_name in ("wikikg2", "biokg", "wikikg90M"):
            raise NotImplementedError(
                f"dglke_tpu_torch does not load {data_name} yet: the ogb "
                "loaders and candidate-list eval are ROADMAP item A8")
        return load_builtin(data_path, data_name)
    if format_str.startswith("raw_udd"):
        return load_raw_udd(data_path, data_name, delimiter, files,
                            format_str[len("raw_udd_"):], has_edge_importance)
    if format_str.startswith("udd"):
        return load_udd(data_path, data_name, delimiter, files,
                        format_str[len("udd_"):], has_edge_importance)
    raise ValueError(f"Unknown format {format_str}")


# ---------------------------------------------------------------------------
# Synthetic data (tests / chip smoke run)


def synthetic_dataset(n_entities: int = 1000, n_relations: int = 20,
                      n_train: int = 20000, n_valid: int = 500,
                      n_test: int = 500, seed: int = 0,
                      name: str = "synthetic") -> KGDataset:
    """Random KG with mild structure (each relation biased to an entity
    block) so that embeddings are learnable above chance.  Draws the same
    triples as the JAX package's generator for the same arguments."""
    rng = np.random.RandomState(seed)

    def sample(n):
        r = rng.randint(0, n_relations, n)
        block = n_entities // n_relations or 1
        h = (r * block + rng.randint(0, max(1, block * 4), n)) % n_entities
        t = (h + r + 1 + rng.randint(0, 3, n)) % n_entities
        return h.astype(np.int64), r.astype(np.int64), t.astype(np.int64)

    return KGDataset(name=name, n_entities=n_entities,
                     n_relations=n_relations, train=sample(n_train),
                     valid=sample(n_valid), test=sample(n_test))


def planted_dataset(structure: str, n_clusters: int = 10, per: int = 6,
                    n_relations: int = 3, seed: int = 0,
                    test_frac: float = 0.15,
                    self_loops: bool = False) -> KGDataset:
    """Planted-structure KGs each model family provably solves (filtered
    MRR ~1.0).  Entities live in ``n_clusters`` clusters of ``per``; edges
    are complete bipartite between cluster pairs, so filtered eval removes
    every other true answer and a model that learns the cluster map ranks
    the held-out edge first.

    structure:
      * "line": r_k maps cluster i -> i+k+1, no wraparound (a constant
        translation: the TransE gate).
      * "cliques": r_k connects all ordered pairs inside clusters with
        cluster % n_relations == k (symmetric); self_loops also plants
        every (x, r, x) edge.
      * "cycle": r_k maps cluster i -> (i+k+1) % n_clusters.
    """
    hs, rs, ts = [], [], []
    if structure == "line":
        for k in range(n_relations):
            for i in range(n_clusters - (k + 1)):
                for a in range(per):
                    for b in range(per):
                        hs.append(i * per + a)
                        rs.append(k)
                        ts.append((i + k + 1) * per + b)
    elif structure == "cliques":
        for i in range(n_clusters):
            k = i % n_relations
            for a in range(per):
                for b in range(per):
                    if a != b or self_loops:
                        hs.append(i * per + a)
                        rs.append(k)
                        ts.append(i * per + b)
    elif structure == "cycle":
        for k in range(n_relations):
            for i in range(n_clusters):
                j = (i + k + 1) % n_clusters
                for a in range(per):
                    for b in range(per):
                        hs.append(i * per + a)
                        rs.append(k)
                        ts.append(j * per + b)
    else:
        raise ValueError(f"unknown planted structure {structure!r}")
    h = np.array(hs, np.int64)
    r = np.array(rs, np.int64)
    t = np.array(ts, np.int64)
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(h))
    h, r, t = h[idx], r[idx], t[idx]
    n_test = int(len(h) * test_frac)
    return KGDataset(name=f"planted_{structure}",
                     n_entities=n_clusters * per, n_relations=n_relations,
                     train=(h[n_test:], r[n_test:], t[n_test:]),
                     test=(h[:n_test], r[:n_test], t[:n_test]))
