"""Knowledge-graph dataset loading (counterpart of dglke_tpu/data/dataset.py).

Covers the layouts the single-device trainer reads:

  * built-in datasets (FB15k, FB15k-237, wn18, wn18rr) in the
    entities.dict/relations.dict + name-triple layout, and the Freebase
    layout (count-only headers, integer triples in h-t-r column order);
  * user-defined pre-mapped datasets ``udd_{hrt-permutation}``;
  * raw user-defined datasets ``raw_udd_{permutation}`` (string triples; the
    loader builds id maps and writes entities.tsv / relations.tsv);
  * custom delimiters and an optional 4th edge-importance column;
  * the ogb datasets (wikikg2, biokg) and wikikg90M, with its
    candidate-list eval splits, through the ``ogb`` package, which is
    imported only when one of them is loaded.

Built-in datasets are read from ``data_path``; a missing one is extracted
from ``{data_path}/{name}.zip``, which is fetched from data.dgl.ai only
when it is missing too.  Synthetic and planted-structure generators for
tests and the chip smoke run live here too.
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
    # candidate-list eval splits (the wikikg90M protocol): dicts of the form
    # {"h,r->t": {"hr": [N,2], "t_candidate": [N,K], "t_correct_index": [N]}}
    valid_dict: Optional[dict] = None
    test_dict: Optional[dict] = None
    # True when train holds one rank's edge partition (partition_for_host):
    # an eval filter must then come from the whole dataset
    train_partitioned: bool = False

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


DATASET_URL = "https://data.dgl.ai/dataset/{}.zip"


def _download_and_extract(url: str, path: str, filename: str) -> None:
    """Unzip ``path/filename``, fetching it from ``url`` first when it is
    absent; an archive that fails to unzip is fetched again once (the
    reference's _download_and_extract, with the standard library's
    urllib)."""
    import urllib.request
    import zipfile

    fn = os.path.join(path, filename)
    for attempt in range(2):
        if os.path.exists(fn):
            try:
                with zipfile.ZipFile(fn) as zf:
                    zf.extractall(path)
                return
            except zipfile.BadZipFile:
                if attempt:
                    raise
                os.remove(fn)
        os.makedirs(path, exist_ok=True)
        tmp = fn + ".part"
        with urllib.request.urlopen(url, timeout=60) as r, \
                open(tmp, "wb") as w:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                w.write(chunk)
        os.replace(tmp, fn)


def load_builtin(data_path: str, name: str) -> KGDataset:
    path = os.path.join(data_path, name)
    if not os.path.exists(path):
        # the archive {data_path}/{name}.zip is extracted; it is fetched
        # only when it is absent too
        url = DATASET_URL.format(name)
        try:
            _download_and_extract(url, data_path, f"{name}.zip")
        except Exception as e:
            raise FileNotFoundError(
                f"Built-in dataset {name} not found at {path} and the "
                f"download from {url} failed ({type(e).__name__}: {e}). "
                "If this environment has no network egress, place the "
                "standard layout (entities.dict, relations.dict, "
                "train.txt, valid.txt, test.txt) there manually.") from e
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"the archive of {name} did not contain a {path}/ directory: "
            "place the standard layout there manually")
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


def _load_ogb(data_path: str, name: str) -> KGDataset:
    """ogbl-wikikg2 / ogbl-biokg through ogb's LinkPropPredDataset."""
    try:
        from ogb.linkproppred import LinkPropPredDataset
    except ImportError as e:
        raise ImportError(
            f"Dataset {name} requires the `ogb` package, which is not "
            "installed in this environment.") from e
    dataset = LinkPropPredDataset(name=f"ogbl-{name}", root=data_path)
    split_edge = dataset.get_edge_split()
    g = dataset[0]
    # edge_reltype is [E, 1] in ogb's dict graph; np.max takes any rank
    n_relations = int(np.max(np.asarray(g["edge_reltype"]))) + 1

    def tri(d):
        return (np.asarray(d["head"], np.int64),
                np.asarray(d["relation"], np.int64),
                np.asarray(d["tail"], np.int64))

    return KGDataset(name=name, n_entities=int(g["num_nodes"]),
                     n_relations=n_relations, train=tri(split_edge["train"]),
                     valid=tri(split_edge["valid"]),
                     test=tri(split_edge["test"]))


def _load_wiki90m(data_path: str) -> KGDataset:
    """wikikg90M (OGB-LSC): train is an [N, 3] hrt array; valid and test
    are 'h,r->t' query dicts with 1,001 tail candidates each."""
    try:
        from ogb.lsc import WikiKG90MDataset
    except ImportError as e:
        raise ImportError(
            "Dataset wikikg90M requires the `ogb` package (ogb.lsc), "
            "which is not installed in this environment.") from e
    dataset = WikiKG90MDataset(data_path)
    hrt = np.asarray(dataset.train_hrt)
    return KGDataset(
        name="wikikg90M", n_entities=int(dataset.num_entities),
        n_relations=int(dataset.num_relations),
        train=(hrt[:, 0].astype(np.int64), hrt[:, 1].astype(np.int64),
               hrt[:, 2].astype(np.int64)),
        valid_dict=dataset.valid_dict, test_dict=dataset.test_dict)


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
        if data_name in ("wikikg2", "biokg"):
            return _load_ogb(data_path, data_name)
        if data_name == "wikikg90M":
            return _load_wiki90m(data_path)
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


def _planted_big(name: str, ks, iis, jjs, per: int, n_entities: int,
                 n_relations: int, rng, n_test: int) -> KGDataset:
    """Each (relation k, cluster i, cluster j) edge of the plan expanded to
    the per x per complete bipartite edges between the clusters' entities,
    shuffled, with a fixed-size test split (int32 ids)."""
    ks, iis, jjs = (np.concatenate(x) for x in (ks, iis, jjs))
    a = np.arange(per, dtype=np.int32)
    shape = (len(ks), per, per)
    h = np.broadcast_to((iis[:, None, None] * per
                         + a[None, :, None]), shape).reshape(-1)
    t = np.broadcast_to((jjs[:, None, None] * per
                         + a[None, None, :]), shape).reshape(-1)
    r = np.broadcast_to(ks[:, None, None], shape).reshape(-1)
    idx = rng.permutation(len(h))
    h, r, t = h[idx].copy(), r[idx].copy(), t[idx].copy()
    n_test = min(n_test, len(h) // 10)
    return KGDataset(name=name, n_entities=n_entities,
                     n_relations=n_relations,
                     train=(h[n_test:], r[n_test:], t[n_test:]),
                     test=(h[:n_test], r[:n_test], t[:n_test]))


def planted_ring_big(n_clusters: int, ring_len: int, per: int = 4,
                     n_relations: int = 1, seed: int = 0,
                     n_test: int = 2000) -> KGDataset:
    """Vectorized cycle structure for the bilinear family (the JAX
    package's planted_ring_big, the same triples): the clusters form
    n_clusters / ring_len independent rings of ring_len, and r_k maps ring
    position i to (i + k + 1) % ring_len."""
    rng = np.random.RandomState(seed)
    if n_clusters % ring_len != 0 or n_relations >= ring_len:
        raise ValueError(f"planted_ring_big: ring_len {ring_len} must divide "
                         f"n_clusters {n_clusters} and exceed n_relations "
                         f"{n_relations}")
    pos = np.arange(n_clusters, dtype=np.int32)
    base = pos - pos % ring_len
    ks, iis, jjs = [], [], []
    for k in range(n_relations):
        ks.append(np.full(n_clusters, k, np.int32))
        iis.append(pos)
        jjs.append(base + (pos % ring_len + k + 1) % ring_len)
    return _planted_big("planted_ring_big", ks, iis, jjs, per,
                        n_clusters * per, n_relations, rng, n_test)


def planted_line_big(n_clusters: int, per: int = 4, n_relations: int = 1,
                     seed: int = 0, n_test: int = 2000,
                     line_len: Optional[int] = None) -> KGDataset:
    """Vectorized Freebase-scale line structure (the JAX package's
    planted_line_big, the same triples): r_k maps cluster i to i + k + 1
    (no wraparound), each cluster pair complete bipartite, a fixed-size
    test split, int32 ids; tens of millions of edges build in seconds.
    ``line_len``: the clusters form n_clusters / line_len independent
    lines instead of one (edges never cross a line)."""
    rng = np.random.RandomState(seed)
    ll = line_len or n_clusters
    if n_relations >= ll:
        raise ValueError(f"planted_line_big: line_len {ll} must exceed "
                         f"n_relations {n_relations}")
    pos = np.arange(n_clusters, dtype=np.int32) % ll
    ks, iis, jjs = [], [], []
    for k in range(n_relations):
        c = np.nonzero(pos < ll - (k + 1))[0].astype(np.int32)
        ks.append(np.full(len(c), k, np.int32))
        iis.append(c)
        jjs.append(c + k + 1)
    return _planted_big("planted_line_big", ks, iis, jjs, per,
                        n_clusters * per, n_relations, rng, n_test)


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
