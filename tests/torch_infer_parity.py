"""Shared by the inference parity tests of dglke_tpu_torch: numpy
checkpoints both packages read, and the rule that holds the port's top-K
lists to the JAX package's.

The rule: scores within rtol 1e-5 / atol 1e-5 of the JAX package's (the
same formulas, fp32 rounding apart); ids identical except at a near tie,
a position whose JAX score has another score of the JAX list within
1e-6 (|s| + gamma) of it (there the two rounding orders may swap
neighbours)."""

import os

import numpy as np

from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.models.score_functions import make_score_function

RTOL = ATOL = 1e-5
TIE_RTOL = 1e-6
# family -> config overrides (RotatE's entity rows hold re | im)
FAMILIES = {"TransE_l2": {}, "TransE_l1": {}, "TransR": {}, "DistMult": {},
            "ComplEx": {}, "RESCAL": {}, "RotatE": dict(double_ent=True),
            "SimplE": {}}


def random_tables(name: str, n_ent: int, n_rel: int, dim: int, seed: int,
                  gamma: float = 4.0, dup=()):
    """Uniform(-1, 1) tables of ``name`` at hidden ``dim``: (entity,
    relation, projection or None).  ``dup`` lists (copy, source) entity
    rows made equal: exact ties."""
    kw = FAMILIES[name]
    _, ed, rd = make_score_function(name, gamma, dim, **kw)
    rng = np.random.default_rng(seed)
    ent = rng.uniform(-1, 1, (n_ent, ed)).astype(np.float32)
    for copy, src in dup:
        ent[copy] = ent[src]
    rel = rng.uniform(-1, 1, (n_rel, rd)).astype(np.float32)
    proj = (rng.uniform(-1, 1, (n_rel, ed * rd)).astype(np.float32)
            if name == "TransR" else None)
    return ent, rel, proj


def write_ckpt(path: str, name: str, ent, rel, proj=None, gamma=4.0,
               dim=8, dataset="toy") -> KGEConfig:
    """A checkpoint in the npy layout both packages write: config.json,
    {dataset}_{model}_entity.npy / _relation.npy and TransR's
    {dataset}_{model}projection.npy."""
    os.makedirs(path, exist_ok=True)
    cfg = KGEConfig(model_name=name, hidden_dim=dim, gamma=gamma,
                    dataset=dataset, save_path=path, **FAMILIES[name])
    prefix = os.path.join(path, f"{dataset}_{name}_")
    np.save(prefix + "entity.npy", ent)
    np.save(prefix + "relation.npy", rel)
    if proj is not None:
        np.save(prefix[:-1] + "projection.npy", proj)
    cfg.save(path)
    return cfg


def assert_top_matches(got, want_all, k: int, gamma: float = 0.0,
                       what: str = ""):
    """``got``: the port's (ids..., scores) top-k; ``want_all``: the JAX
    package's whole ordered list (ids..., scores)."""
    *g_ids, g_s = (np.asarray(x) for x in got)
    *w_ids, w_s = (np.asarray(x) for x in want_all)
    n = min(k, len(w_s))
    assert len(g_s) == n, (what, len(g_s), n)
    np.testing.assert_allclose(g_s, w_s[:n], rtol=RTOL, atol=ATOL,
                               err_msg=what)
    differ = np.zeros(n, bool)
    for g, w in zip(g_ids, w_ids):
        assert g.dtype.kind == w.dtype.kind, (what, g.dtype, w.dtype)
        differ |= g != w[:n]
    for i in np.flatnonzero(differ):
        near = np.abs(w_s - w_s[i]) <= TIE_RTOL * (abs(w_s[i]) + gamma)
        assert near.sum() >= 2, (
            f"{what}: position {i} differs from the JAX package's with no "
            f"near tie (score {w_s[i]!r})")


def assert_ties_lower_first(ids, scores, what: str = ""):
    """Among equal scores of one list, the ids (flat positions) ascend."""
    ids, scores = np.asarray(ids), np.asarray(scores)
    for s in np.unique(scores):
        at = ids[scores == s]
        assert (np.diff(at) > 0).all(), (what, s, at)
