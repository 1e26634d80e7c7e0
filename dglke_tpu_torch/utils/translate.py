"""Raw-id <-> integer-id translation loaders for the inference CLIs
(counterpart of dglke_tpu/utils/translate.py; the reference's
utils.py loaders)."""

from __future__ import annotations

import csv
from typing import Dict, Optional, Tuple

import numpy as np


def _read_map(map_f: str) -> Tuple[Dict[str, int], Dict[int, str]]:
    fwd, inv = {}, {}
    with open(map_f) as f:
        for row in csv.reader(f, delimiter="\t"):
            fwd[row[1]] = int(row[0])
            inv[int(row[0])] = row[1]
    return fwd, inv


def _read_list(path: Optional[str], mapper=None):
    if path is None:
        return None
    out = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            out.append(mapper[line] if mapper is not None else int(line))
    return np.asarray(out)


def load_raw_triplet_data(head_f=None, rel_f=None, tail_f=None, emap_f=None,
                          rmap_f=None):
    eid_map = id2e_map = rid_map = id2r_map = None
    if emap_f is not None:
        eid_map, id2e_map = _read_map(emap_f)
    if rmap_f is not None:
        rid_map, id2r_map = _read_map(rmap_f)
    head = _read_list(head_f, eid_map)
    rel = _read_list(rel_f, rid_map)
    tail = _read_list(tail_f, eid_map)
    return head, rel, tail, id2e_map, id2r_map


def load_triplet_data(head_f=None, rel_f=None, tail_f=None):
    return _read_list(head_f), _read_list(rel_f), _read_list(tail_f)


def load_raw_emb_mapping(map_f: str) -> Dict[int, str]:
    id2e = {}
    with open(map_f) as f:
        for row in csv.reader(f, delimiter="\t"):
            id2e[int(row[0])] = row[1]
    return id2e


def load_raw_emb_data(file, map_f=None, e2id_map=None):
    if map_f is not None:
        e2id_map, id2e_map = _read_map(map_f)
    elif e2id_map is not None:
        id2e_map = []
    else:
        raise ValueError("raw-id translation needs an ID mapping file")
    ids = _read_list(file, e2id_map)
    return ids, id2e_map, e2id_map


def load_entity_data(file=None):
    return _read_list(file)
