"""dglke_tpu_torch's inference core against the JAX package's, on the same
numpy tables and ids (JAX on the CPU, the port with device="cpu", so that
K1 takes its plain version).

  * infer_score of every family, TransR's all-pairs form and the blocked
    forms (RESCAL in both orders, RotatE over tail blocks): within rtol
    1e-5 / atol 1e-5 of the JAX package's;
  * ScoreInfer.topK in all 5 exec modes x none / logsigmoid for every
    family, EmbSimInfer.topK with all 5 similarity functions x 3 modes:
    scores within the same tolerance, ids identical but at near ties
    within 1e-6 (|s| + gamma) of the JAX scores (torch_infer_parity);
  * tables with planted duplicate rows: the port scores the copies the
    same, bit for bit, and lists them lower flat index first;
  * topk_desc against numpy's stable argsort on data full of ties.
"""

import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (on the CPU: tests/conftest.py)
import jax.numpy as jnp

from dglke_tpu.models import infer as jinfer
from dglke_tpu.models import score_functions as jsf
from dglke_tpu_torch.models import infer as pinfer
from dglke_tpu_torch.models import score_functions as psf
from dglke_tpu_torch.utils.io import load_config_json
from torch_infer_parity import (
    ATOL,
    FAMILIES,
    RTOL,
    assert_ties_lower_first,
    assert_top_matches,
    random_tables,
    write_ckpt,
)

torch.set_num_threads(2)

N_ENT, N_REL, DIM, GAMMA = 30, 5, 8, 4.0
HEAD, REL, TAIL = [1, 4, 7, 2], [0, 3, 1], [5, 6, 9, 0, 11, 3]
MODES = ["triplet_wise", "all", "batch_head", "batch_rel", "batch_tail"]


def _score_fns(name, gamma=GAMMA):
    kw = FAMILIES[name]
    return (jsf.make_score_function(name, gamma, DIM, **kw)[0],
            psf.make_score_function(name, gamma, DIM, **kw)[0])


@pytest.mark.parametrize("name", [n for n in FAMILIES if n != "TransR"])
def test_infer_score_matches_jax(name):
    ent, rel, _ = random_tables(name, N_ENT, N_REL, DIM, seed=0)
    j, p = _score_fns(name)
    h, t = ent[:4], ent[4:11]
    want = np.asarray(j.infer_score(jnp.asarray(h), jnp.asarray(rel),
                                    jnp.asarray(t)))
    got = p.infer_score(torch.from_numpy(h), torch.from_numpy(rel),
                        torch.from_numpy(t))
    assert got.shape == want.shape == (4, N_REL, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("budget", [1, 1 << 25], ids=["tile1", "one_tile"])
def test_transr_allpairs_matches_jax(budget):
    ent, rel, proj = random_tables("TransR", N_ENT, N_REL, DIM, seed=1)
    h, t = ent[:3], ent[3:12]
    want = jsf.transr_allpairs_score(h, t, proj, rel, GAMMA, DIM, DIM,
                                     budget=budget)
    got = psf.transr_allpairs_score(
        *(torch.from_numpy(x) for x in (h, t, proj, rel)), GAMMA, DIM, DIM,
        budget=budget)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError, match="transr_allpairs_score"):
        psf.make_score_function("TransR", GAMMA, DIM)[0].infer_score(
            got, got, got)


@pytest.mark.parametrize("name,n_head,n_tail,budget", [
    ("RESCAL", 3, 9, None),      # h^T R first
    ("RESCAL", 9, 3, None),      # R t first, as the JAX package
    ("RESCAL", 9, 3, 64),        # relations one at a time
    ("RotatE", 3, 9, 40),        # tails in blocks of 3
])
def test_blocked_infer_score_matches_jax(monkeypatch, name, n_head, n_tail,
                                         budget):
    if budget is not None:
        monkeypatch.setattr(psf, "INFER_BUDGET", budget)
    ent, rel, _ = random_tables(name, N_ENT, N_REL, DIM, seed=2)
    j, p = _score_fns(name)
    h, t = ent[:n_head], ent[n_head:n_head + n_tail]
    want = np.asarray(j.infer_score(jnp.asarray(h), jnp.asarray(rel),
                                    jnp.asarray(t)))
    got = p.infer_score(*(torch.from_numpy(x) for x in (h, rel, t)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dist_ord", [1, 2])
def test_transe_self_pair_at_gamma_zero(dist_ord):
    """Under score_func none gamma is 0: a head that is its own tail under
    a zero relation scores -1e-15 in L2 (the JAX _norm's +1e-30 inside the
    sqrt), -0 in L1, as the JAX package scores them."""
    e = np.zeros((1, 4), np.float32)
    want = np.asarray(jsf.TransEScore(0.0, dist_ord).infer_score(
        jnp.asarray(e), jnp.asarray(e), jnp.asarray(e)))
    got = psf.TransEScore(0.0, dist_ord).infer_score(
        *(torch.from_numpy(e),) * 3).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.item() == (np.float32(-1e-15) if dist_ord == 2 else 0.0)


@pytest.mark.parametrize("seed", range(4))
def test_topk_desc_is_the_stable_argsort(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 3, size=(5, 40)).astype(np.float32)
    x[0] = 1.0                                     # one row all tied
    for k in (0, 1, 3, 17, 39, 40, 50):
        want = np.stack([np.argsort(-row, kind="stable")[:k] for row in x])
        got = pinfer.topk_desc(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            pinfer.topk_desc(torch.from_numpy(x[1]), k).numpy(), want[1])


# ---------------------------------------------------------------------------
# ScoreInfer / EmbSimInfer through a checkpoint


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One checkpoint a family, each with planted duplicate entity rows
    (6 = 5 and 0 = 9 = 3)."""
    out = {}
    for i, name in enumerate(FAMILIES):
        path = str(tmp_path_factory.mktemp(name))
        tables = random_tables(name, N_ENT, N_REL, DIM, seed=10 + i,
                               dup=[(6, 5), (0, 3), (9, 3)])
        write_ckpt(path, name, *tables, gamma=GAMMA, dim=DIM)
        out[name] = path
    return out


def _infer(pkg, path, sfunc):
    mod = jinfer if pkg == "jax" else pinfer
    args = (-1,) if pkg == "jax" else ("cpu",)
    si = mod.ScoreInfer(*args, load_config_json(path), path, sfunc)
    si.load_model()
    return si


@pytest.mark.parametrize("sfunc", ["none", "logsigmoid"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(FAMILIES))
def test_score_infer_topk_matches_jax(ckpts, name, mode, sfunc):
    if mode == "triplet_wise":
        h, r, t = [1, 4, 7, 2, 6, 5], [0, 3, 1, 1, 2, 2], [5, 6, 9, 0, 3, 3]
    else:
        h, r, t = HEAD, REL, TAIL
    k = 7
    got = _infer("torch", ckpts[name], sfunc).topK(h, r, t, mode, k)
    want = _infer("jax", ckpts[name], sfunc).topK(h, r, t, mode, 10 ** 6)
    assert len(got) == len(want)
    gamma = GAMMA if sfunc == "logsigmoid" else 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        assert_top_matches(g, w, k, gamma, what=f"{name} {mode} block {i}")


@pytest.mark.parametrize("mode", ["all", "batch_head", "triplet_wise"])
@pytest.mark.parametrize("name", ["TransE_l2", "TransE_l1", "DistMult",
                                  "RESCAL", "RotatE"])
def test_score_infer_exact_ties_lower_index_first(ckpts, name, mode):
    """Tails 0, 3 and 9 hold one row, as do 5 and 6: the port scores the
    copies the same, bit for bit, and lists them lower flat index first."""
    if mode == "triplet_wise":
        h, r, t = [1, 1, 1, 2, 2], [0, 0, 0, 4, 4], [3, 9, 0, 6, 5]
    else:
        h, r, t = [1, 2], [0, 4], [9, 5, 3, 6, 0, 8]
    k = 10 ** 6
    (bh, br, bt, s), *rest = _infer("torch", ckpts[name], "none").topK(
        h, r, t, mode, k)
    if mode == "triplet_wise":
        pos = {(a, b, c): i for i, (a, b, c) in enumerate(zip(h, r, t))}
    else:
        pos = {(a, b, c): (ih * len(r) + ir) * len(t) + it
               for ih, a in enumerate(h if mode == "all" else h[:1])
               for ir, b in enumerate(r) for it, c in enumerate(t)}
    flat = np.array([pos[x] for x in zip(bh, br, bt)])
    assert_ties_lower_first(flat, s, what=f"{name} {mode}")
    by = dict(zip(zip(bh, br, bt), s))
    first_h, first_r = (h[0], r[0])
    copies = [by[(first_h, first_r, c)] for c in (3, 9, 0)
              if (first_h, first_r, c) in by]
    assert len(copies) >= 2 and len(set(copies)) == 1, copies


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("triplet_wise", [False, True])
def test_infer_model_score_matches_jax(ckpts, name, triplet_wise):
    path = ckpts[name]
    cfg = load_config_json(path)
    jm = jinfer.ScoreInfer(-1, cfg, path, "none")
    pm = pinfer.ScoreInfer("cpu", cfg, path, "none")
    jm.load_model()
    pm.load_model()
    h, r, t = ([3, 1, 2], [0, 4, 2], [7, 8, 0]) if triplet_wise \
        else (HEAD, REL, TAIL)
    want = jm.model.score(np.asarray(h), np.asarray(r), np.asarray(t),
                          triplet_wise=triplet_wise)
    got = pm.model.score(h, r, t, triplet_wise=triplet_wise)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_score_infer_reads_the_reference_transr_layout(tmp_path):
    """The projection table under dgl-ke's spelling (no separating
    underscore) and under the JAX package's both load and agree."""
    ent, rel, proj = random_tables("TransR", 20, 3, 4, seed=3)
    write_ckpt(str(tmp_path / "a"), "TransR", ent, rel, proj, dim=4)
    write_ckpt(str(tmp_path / "b"), "TransR", ent, rel, dim=4)
    np.save(tmp_path / "b" / "toy_TransR_projection.npy", proj)
    res = [_infer("torch", str(tmp_path / d), "none").topK(
        [0, 1], [0, 2], [2, 3, 4], k=4)[0] for d in ("a", "b")]
    want = _infer("jax", str(tmp_path / "a"), "none").topK(
        [0, 1], [0, 2], [2, 3, 4], k=100)[0]
    for got in res:
        assert_top_matches(got, want, 4)


def test_score_infer_refuses_unknown_sfunc_and_mode(ckpts):
    with pytest.raises(ValueError, match="sfunc"):
        pinfer.ScoreInfer("cpu", {}, ckpts["TransE_l2"], "sigmoid")
    with pytest.raises(ValueError, match="unknown execution mode"):
        _infer("torch", ckpts["TransE_l2"], "none").topK(
            [1], [0], [2], "batch_all")
    with pytest.raises(ValueError, match="lengths must match"):
        _infer("torch", ckpts["TransE_l2"], "none").topK(
            [1, 2], [0], [2], "triplet_wise")
    with pytest.raises(IndexError, match="outside"):
        _infer("torch", ckpts["TransE_l2"], "none").topK([N_ENT], [0], [2])


@pytest.mark.parametrize("mode", ["pairwise", "all", "batch_left"])
@pytest.mark.parametrize("sfunc", list(pinfer.SIM_FUNCS))
def test_emb_sim_topk_matches_jax(ckpts, sfunc, mode):
    emb_file = os.path.join(ckpts["TransE_l2"], "toy_TransE_l2_entity.npy")
    left = [0, 1, 2, 5, 8]
    right = [4, 5, 6, 7, 3] if mode == "pairwise" else [4, 5, 6, 7, 3, 12, 0]
    kw = dict(bcast=mode == "batch_left", pair_ws=mode == "pairwise")
    j = jinfer.EmbSimInfer(-1, emb_file, sfunc, batch_size=3)
    p = pinfer.EmbSimInfer("cpu", emb_file, sfunc, batch_size=3)
    j.load_emb()
    p.load_emb()
    got = p.topK(left, right, k=4, **kw)
    want = j.topK(left, right, k=10 ** 6, **kw)
    assert len(got) == len(want) == (len(left) if kw["bcast"] else 1)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_top_matches(g, w, 4, what=f"{sfunc} {mode} row {i}")


@pytest.mark.parametrize("sfunc", list(pinfer.SIM_FUNCS))
def test_emb_sim_exact_ties_lower_index_first(ckpts, sfunc):
    """Rows 0, 3 and 9 are one row, as are 5 and 6: their similarities to
    a left row are bit-equal and listed lower right index first."""
    emb_file = os.path.join(ckpts["DistMult"], "toy_DistMult_entity.npy")
    p = pinfer.EmbSimInfer("cpu", emb_file, sfunc)
    p.load_emb()
    right = np.array([9, 5, 3, 6, 0, 8, 1])
    for left_row in p.topK([1, 2], right, bcast=True, k=100):
        l, r, s = left_row
        pos = {v: i for i, v in enumerate(right)}
        assert_ties_lower_first([pos[x] for x in r], s, what=sfunc)
        by = dict(zip(r, s))
        assert by[0] == by[3] == by[9] and by[5] == by[6]
