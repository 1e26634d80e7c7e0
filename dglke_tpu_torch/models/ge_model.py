"""The object-level graph-embedding model API (counterpart of
dglke_tpu/models/ge_model.py, the reference's "new model API").

  * ``BasicGEModel.link_predict``: top-K missing-link prediction under 5
    exec modes (triplet_wise / all / batch_head / batch_rel / batch_tail),
    optional logsigmoid squashing, and 3 exclude modes (None / 'mask' /
    'exclude') that consult the attached graph's known edges.
  * ``BasicGEModel.embed_sim``: similarity top-K over the entity or the
    relation table.
  * ``KGEModel.load``: ``entity.npy`` / ``relation.npy`` (and TransR's
    projection table), or a trainer checkpoint's prefixed files.
  * The per-family classes and GNNModel (externally trained embeddings
    scored with TransE or DistMult).

The tables live on the model's device ("cuda" unless the caller passes
device="cpu"; an integer gpu id, as the JAX package takes, selects the
card).  Scores, rows (K1) and the top-K come from models/infer.py's core;
the attached graph is a ``TripleSet`` on the host, and membership is one
vectorized ``searchsorted`` over the candidates that come back.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from dglke_tpu_torch.device import resolve_api_device
from dglke_tpu_torch.models.infer import (
    DEFAULT_INFER_BATCHSIZE,
    SIM_FUNCS,
    decode,
    scored_blocks,
    sim_topk,
    squash,
    table_on,
    top_results,
    topk_desc,
)
from dglke_tpu_torch.models.score_functions import (
    ComplExScore,
    DistMultScore,
    RESCALScore,
    RotatEScore,
    TransEScore,
    TransRScore,
)

EMB_INIT_EPS = 2.0


class TripleSet:
    """Membership index over a set of (h, r, t) triples, on the host: the
    sorted unique (h, t) composite keys and, per (h, t) group, its sorted
    (group, r) keys give a vectorized O(log E) ``contains``.  Keys are
    built in two levels so that they never overflow int64, even at
    Freebase scale (86M entities)."""

    def __init__(self, head: np.ndarray, rel: np.ndarray, tail: np.ndarray,
                 n_entities: int, n_relations: int):
        head = np.asarray(head, dtype=np.int64)
        rel = np.asarray(rel, dtype=np.int64)
        tail = np.asarray(tail, dtype=np.int64)
        # The key bases follow the data as well as the declared counts:
        # attach_graph may run before the tables load (num_entity == -1),
        # and a base below the ids would make keys collide.
        self.n_entities = max(int(n_entities),
                              int(head.max()) + 1 if len(head) else 1,
                              int(tail.max()) + 1 if len(tail) else 1, 1)
        self.n_relations = max(int(n_relations),
                               int(rel.max()) + 1 if len(rel) else 1, 1)
        self.num_edges = len(head)
        self._head, self._rel, self._tail = head, rel, tail
        ht = head * self.n_entities + tail
        self._ht_keys, inv = np.unique(ht, return_inverse=True)
        self._gr_keys = np.sort(inv.astype(np.int64) * self.n_relations + rel)

    def contains(self, head: np.ndarray, rel: np.ndarray,
                 tail: np.ndarray) -> np.ndarray:
        """Vectorized membership: bool[N] for N candidate triples."""
        head = np.asarray(head, dtype=np.int64)
        rel = np.asarray(rel, dtype=np.int64)
        tail = np.asarray(tail, dtype=np.int64)
        if self.num_edges == 0:
            return np.zeros(head.shape, dtype=bool)
        # ids beyond the key bases cannot be members (and would collide)
        in_range = ((head < self.n_entities) & (tail < self.n_entities)
                    & (rel < self.n_relations) & (head >= 0) & (tail >= 0)
                    & (rel >= 0))
        head = np.minimum(head, self.n_entities - 1)
        tail = np.minimum(tail, self.n_entities - 1)
        rel = np.minimum(rel, self.n_relations - 1)
        ht = head * self.n_entities + tail
        pos = np.minimum(np.searchsorted(self._ht_keys, ht),
                         len(self._ht_keys) - 1)
        ht_hit = self._ht_keys[pos] == ht
        gr = pos * self.n_relations + rel
        gpos = np.minimum(np.searchsorted(self._gr_keys, gr),
                          len(self._gr_keys) - 1)
        return ht_hit & (self._gr_keys[gpos] == gr) & in_range

    @property
    def edges(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self._head, self._rel, self._tail


def _as_triple_set(g, n_entities: int, n_relations: int) -> TripleSet:
    if isinstance(g, TripleSet):
        return g
    if hasattr(g, "train"):  # a KGDataset: every split it has
        splits = [s for s in (g.train, getattr(g, "valid", None),
                              getattr(g, "test", None)) if s is not None]
        return TripleSet(*(np.concatenate([s[i] for s in splits])
                           for i in range(3)), g.n_entities, g.n_relations)
    h, r, t = g
    return TripleSet(h, r, t, n_entities, n_relations)


class BasicGEModel:
    """A graph-embedding model over loaded tables (reference
    BasicGEModel)."""

    def __init__(self, device=None, model_name: str = "TransE_l2",
                 score_func=None):
        self._g: Optional[TripleSet] = None
        self._model_name = model_name
        self._device = resolve_api_device(device)
        self._score_func = score_func
        self._entity_emb = self._relation_emb = None
        self._projection_emb = None  # TransR only

    # -- attachment / IO ----------------------------------------------------

    def attach_graph(self, g, etid_field="tid", ntid_filed="ntid"):
        """Attach the known edges that link_predict's exclude modes consult:
        a KGDataset, a (head, rel, tail) array triple or a TripleSet (the
        reference takes a DGLGraph)."""
        self._g = _as_triple_set(g, self.num_entity, self.num_rel)

    def load_emb(self, entity_emb, relation_emb):
        self._entity_emb = table_on(self._device, entity_emb)
        self._relation_emb = table_on(self._device, relation_emb)

    def load(self, model_path: str):
        raise NotImplementedError

    def save(self, model_path: str):
        raise NotImplementedError(
            "this model class is inference-only; save via "
            "dglke_tpu_torch-train")

    def fit(self):
        raise NotImplementedError(
            "this model class is inference-only; train with "
            "dglke_tpu_torch.trainer")

    def eval(self):
        raise NotImplementedError(
            "this model class is inference-only; evaluate with "
            "dglke_tpu_torch.trainer.evaluate")

    # -- link prediction ----------------------------------------------------

    def _topk_exclude_pos(self, score, head, rel, tail, topk: int,
                          triplet_wise: bool, exclude_mode: Optional[str]):
        """Top-K of one block's scores with the known edges flagged (mask)
        or dropped (exclude): exclude takes the top topk*4 first and the
        whole list only when too many of them are known edges (the
        reference's escalation)."""
        n = score.shape[0]
        if exclude_mode == "exclude":
            for cut in (min(topk * 4, n), n):
                cand = topk_desc(score, cut)
                s = score[cand].cpu().numpy()
                h, r, t = decode(cand.cpu().numpy(), head, rel, tail,
                                 triplet_wise)
                keep = ~self._g.contains(h, r, t)
                if keep.sum() >= topk or cut == n:
                    sel = np.flatnonzero(keep)[:topk]
                    return h[sel], r[sel], t[sel], s[sel], None
        h, r, t, s = top_results(score, topk, head, rel, tail, triplet_wise)
        mask = self._g.contains(h, r, t) if exclude_mode == "mask" else None
        return h, r, t, s, mask

    def link_predict(self, head=None, rel=None, tail=None,
                     exec_mode: str = "all", sfunc: str = "none",
                     topk: int = 10, exclude_mode: Optional[str] = None,
                     batch_size: int = DEFAULT_INFER_BATCHSIZE) -> List[Tuple]:
        """The top-K most relevant triples: a list of (head_ids, rel_ids,
        tail_ids, scores, mask), one element for triplet_wise and all, one
        per batch element for the batch_* modes; ``mask`` is None unless
        exclude_mode == 'mask'."""
        head = np.arange(self.num_entity) if head is None \
            else np.asarray(head, dtype=np.int64)
        rel = np.arange(self.num_rel) if rel is None \
            else np.asarray(rel, dtype=np.int64)
        tail = np.arange(self.num_entity) if tail is None \
            else np.asarray(tail, dtype=np.int64)
        if exclude_mode not in (None, "mask", "exclude"):
            raise ValueError(f"unknown exclude_mode {exclude_mode}")
        if self._g is None and exclude_mode is not None:
            raise ValueError("If exclude_mode is not None, please use "
                             "attach_graph() to initialize a graph for edge "
                             "filtering.")
        return [self._topk_exclude_pos(squash(s, sfunc), h, r, t, topk,
                                       exec_mode == "triplet_wise",
                                       exclude_mode)
                for s, h, r, t in scored_blocks(
                    self._score_func, self._entity_emb, self._relation_emb,
                    self._projection_emb, head, rel, tail, exec_mode,
                    batch_size)]

    # -- embedding similarity -----------------------------------------------

    def embed_sim(self, left=None, right=None, embed_type: str = "entity",
                  sfunc: str = "cosine", bcast: bool = False,
                  pair_ws: bool = False, topk: int = 10,
                  batch_size: int = DEFAULT_INFER_BATCHSIZE) -> List[Tuple]:
        """Similarity top-K over the entity or relation table:
        [(left_ids, right_ids, scores)]."""
        if embed_type == "entity":
            emb = self._entity_emb
        elif embed_type == "relation":
            emb = self._relation_emb
        else:
            raise ValueError("emb must be 'entity' or 'relation'")
        left = np.arange(emb.shape[0]) if left is None \
            else np.asarray(left, dtype=np.int64)
        right = np.arange(emb.shape[0]) if right is None \
            else np.asarray(right, dtype=np.int64)
        return sim_topk(emb, left, right, SIM_FUNCS[sfunc], bcast, pair_ws,
                        topk, batch_size)

    # -- properties ----------------------------------------------------------

    @property
    def model_name(self):
        return self._model_name

    @property
    def entity_embed(self):
        return self._entity_emb

    @property
    def relation_embed(self):
        return self._relation_emb

    @property
    def num_entity(self):
        return -1 if self._entity_emb is None else self._entity_emb.shape[0]

    @property
    def num_rel(self):
        return -1 if self._relation_emb is None \
            else self._relation_emb.shape[0]

    @property
    def graph(self):
        return self._g


def _load_npy(path: str, *names: str) -> np.ndarray:
    """The first of ``names`` under ``path``; else the one ``*_<name>``
    match, so that a trainer checkpoint ({dataset}_{model}_entity.npy)
    loads directly."""
    for name in names:
        f = os.path.join(path, name)
        if os.path.exists(f):
            return np.load(f)
    for name in names:
        hits = sorted(glob.glob(os.path.join(path, f"*_{name}")))
        hits = [h for h in hits if not h.endswith("_state.npy")]
        if len(hits) == 1:
            return np.load(hits[0])
        if len(hits) > 1:
            raise FileNotFoundError(
                f"{name} not found under {path} and fallback glob *_{name} "
                f"is ambiguous: {hits}")
    raise FileNotFoundError(f"none of {names} found under {path}")


class KGEModel(BasicGEModel):
    """A model loaded from entity.npy / relation.npy (reference
    KGEModel)."""

    def load(self, model_path: str):
        self.load_emb(_load_npy(model_path, "entity.npy"),
                      _load_npy(model_path, "relation.npy"))


class TransEModel(KGEModel):
    def __init__(self, device=None, gamma: float = 12.0):
        self._gamma = gamma
        super().__init__(device, "TransE", TransEScore(gamma, 2))


class TransE_l2Model(KGEModel):
    def __init__(self, device=None, gamma: float = 12.0):
        self._gamma = gamma
        super().__init__(device, "TransE_l2", TransEScore(gamma, 2))


class TransE_l1Model(KGEModel):
    def __init__(self, device=None, gamma: float = 12.0):
        self._gamma = gamma
        super().__init__(device, "TransE_l1", TransEScore(gamma, 1))


class TransRModel(KGEModel):
    def __init__(self, device=None, gamma: float = 12.0):
        self._gamma = gamma
        super().__init__(device, "TransR",
                         TransRScore(gamma, entity_dim=-1, relation_dim=-1))

    def load(self, model_path: str):
        super().load(model_path)
        proj = _load_npy(model_path, f"{self.model_name}projection.npy",
                         "projection.npy")
        self._score_func = dataclasses.replace(
            self._score_func, entity_dim=self._entity_emb.shape[1],
            relation_dim=self._relation_emb.shape[1])
        self._projection_emb = table_on(self._device, proj)


class DistMultModel(KGEModel):
    def __init__(self, device=None):
        super().__init__(device, "DistMult", DistMultScore())


class ComplExModel(KGEModel):
    def __init__(self, device=None):
        super().__init__(device, "ComplEx", ComplExScore())


class RESCALModel(KGEModel):
    def __init__(self, device=None):
        super().__init__(device, "RESCAL",
                         RESCALScore(relation_dim=-1, entity_dim=-1))

    def load(self, model_path: str):
        super().load(model_path)
        entity_dim = self._entity_emb.shape[1]
        self._score_func = dataclasses.replace(
            self._score_func, entity_dim=entity_dim,
            relation_dim=self._relation_emb.shape[1] // entity_dim)


class RotatEModel(KGEModel):
    def __init__(self, device=None, gamma: float = 12.0):
        self._gamma = gamma
        super().__init__(device, "RotatE", RotatEScore(gamma, emb_init=1.0))

    def load(self, model_path: str):
        super().load(model_path)
        hidden_dim = self._entity_emb.shape[1] // 2
        self._score_func = dataclasses.replace(
            self._score_func,
            emb_init=(self._gamma + EMB_INIT_EPS) / hidden_dim)


class GNNModel(BasicGEModel):
    """Externally trained (e.g. GNN) embeddings scored with a simple score
    function (reference GNNModel)."""

    def __init__(self, device=None, model_name: str = "TransE_l2",
                 gamma: float = 0.0):
        if model_name in ("TransE", "TransE_l2"):
            score_func = TransEScore(gamma, dist_ord=2)
        elif model_name == "TransE_l1":
            score_func = TransEScore(gamma, dist_ord=1)
        elif model_name == "DistMult":
            score_func = DistMultScore()
        else:
            raise ValueError(
                "For general purpose scoring of GNN embeddings only "
                "TransE_l1, TransE_l2 and DistMult are supported, "
                f"got {model_name}")
        super().__init__(device, model_name, score_func)

    def load(self, model_path: str):
        self.load_emb(_load_npy(model_path, "entity.npy"),
                      _load_npy(model_path, "relation.npy"))
