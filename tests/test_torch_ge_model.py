"""dglke_tpu_torch's object model API (models/ge_model.py) on the cases of
tests/test_ge_model.py and tests/test_ge_model_load.py, run against both
packages on the same checkpoints: the port (device="cpu") is held to the
brute-force loops of those tests and to the JAX package's results (scores
within rtol 1e-5 / atol 1e-5, ids identical but at near ties, masks and
exclusions identical).  The entry points default to the card: without
one they raise, and no integer gpu id moves them to the CPU.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (on the CPU: tests/conftest.py)

from dglke_tpu.models import ge_model as J
from dglke_tpu_torch.models import ge_model as P
from test_ge_model import (
    DIM,
    N_ENT,
    N_REL,
    _random_graph,
    _save_ckpt,
    _score_loop,
)
from torch_infer_parity import assert_top_matches

torch.set_num_threads(2)

ALL = 10 ** 6          # a topk past every candidate: the whole JAX list


def _pair(tmp_path, cls, **kw):
    """The same checkpoint loaded by the JAX class and the port's."""
    j = getattr(J, cls)(**kw)
    p = getattr(P, cls)(device="cpu", **kw)
    j.load(str(tmp_path))
    p.load(str(tmp_path))
    return j, p


def _link(model, topk, **kw):
    return model.link_predict(topk=topk, **kw)


def _assert_link_matches(p, j, k, gamma=12.0, **kw):
    """Every result element of the port's link_predict against the JAX
    package's whole list; returns the port's result."""
    got, want = _link(p, k, **kw), _link(j, ALL, **kw)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[4] is None and w[4] is None
        assert_top_matches(g[:4], w[:4], k, gamma, what=f"element {i}")
    return got


# ---------------------------------------------------------------------------
# TripleSet


def test_triple_set_membership():
    rng = np.random.default_rng(0)
    h, r, t = _random_graph(rng)
    ts, jts = P.TripleSet(h, r, t, N_ENT, N_REL), J.TripleSet(h, r, t,
                                                             N_ENT, N_REL)
    assert ts.contains(h, r, t).all()
    r2 = (r + 1) % N_REL
    real = set(zip(h.tolist(), r.tolist(), t.tolist()))
    expected = np.array([x in real for x in zip(h, r2, t)])
    np.testing.assert_array_equal(ts.contains(h, r2, t), expected)
    hh, rr, tt = (rng.integers(-2, N_ENT + 2, 500) for _ in range(3))
    np.testing.assert_array_equal(ts.contains(hh, rr, tt),
                                  jts.contains(hh, rr, tt))
    for a, b in zip(ts.edges, jts.edges):
        np.testing.assert_array_equal(a, b)


def test_triple_set_empty():
    ts = P.TripleSet(np.array([]), np.array([]), np.array([]), N_ENT, N_REL)
    assert not ts.contains(np.array([1]), np.array([2]), np.array([3])).any()


def test_triple_set_no_int64_overflow():
    n_ent, n_rel = 86_054_151, 14_824
    h = np.array([n_ent - 1, 12345])
    r = np.array([n_rel - 1, 77])
    t = np.array([n_ent - 2, 999])
    ts = P.TripleSet(h, r, t, n_ent, n_rel)
    assert ts.contains(h, r, t).all()
    assert not ts.contains(h, (r + 1) % n_rel, t).any()


def test_tripleset_order_independent_attach():
    ts = P.TripleSet([1], [0], [3], -1, 5)
    assert not ts.contains([2], [0], [4])[0]
    assert ts.contains([1], [0], [3])[0]
    assert not ts.contains([100], [0], [100])[0]


# ---------------------------------------------------------------------------
# link_predict


@pytest.mark.parametrize("name,cls", [
    ("TransE_l2", "TransE_l2Model"), ("TransE_l1", "TransE_l1Model"),
    ("DistMult", "DistMultModel"), ("ComplEx", "ComplExModel"),
    ("RotatE", "RotatEModel")])
def test_link_predict_all_mode(tmp_path, name, cls):
    rng = np.random.default_rng(1)
    rel_dim = DIM // 2 if name == "RotatE" else DIM
    ent, rel_emb = _save_ckpt(tmp_path, rng, rel_dim=rel_dim)
    kw = {} if name in ("DistMult", "ComplEx") else dict(gamma=12.0)
    j, p = _pair(tmp_path, cls, **kw)
    head, rel, tail = np.array([0, 1, 2, 3]), np.array([0, 1]), \
        np.array([4, 5, 6])
    (h, r, t, score, _), = _assert_link_matches(
        p, j, 5, head=head, rel=rel, tail=tail, exec_mode="all")
    hh, rr, tt = (x.ravel() for x in np.meshgrid(head, rel, tail,
                                                 indexing="ij"))
    ref = _score_loop(name, ent, rel_emb, hh, rr, tt)
    order = np.argsort(-ref, kind="stable")[:5]
    np.testing.assert_allclose(score, ref[order], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(t, tt[order])


def test_link_predict_transr(tmp_path):
    rng = np.random.default_rng(2)
    ent, rel_emb, proj = _save_ckpt(tmp_path, rng, rel_dim=8, proj=True)
    j, p = _pair(tmp_path, "TransRModel", gamma=12.0)
    head, rel, tail = np.array([0, 1, 2]), np.array([0, 1]), np.array([3, 4])
    for mode in ("all", "batch_rel"):
        _assert_link_matches(p, j, 4, head=head, rel=rel, tail=tail,
                             exec_mode=mode)
    (h, r, t, score, _), = _link(p, 4, head=head, rel=rel, tail=tail)
    hh, rr, tt = (x.ravel() for x in np.meshgrid(head, rel, tail,
                                                 indexing="ij"))
    ref = _score_loop("TransR", ent, rel_emb, hh, rr, tt, proj=proj)
    order = np.argsort(-ref, kind="stable")[:4]
    np.testing.assert_allclose(score, ref[order], rtol=2e-4, atol=2e-4)
    # triplet_wise projects each triple by its own relation
    th, tr, tt3 = np.array([0, 5, 9]), np.array([1, 0, 1]), \
        np.array([2, 2, 7])
    _assert_link_matches(p, j, 3, head=th, rel=tr, tail=tt3,
                         exec_mode="triplet_wise")


def test_link_predict_rescal(tmp_path):
    rng = np.random.default_rng(3)
    ent, rel_emb = _save_ckpt(tmp_path, rng, rel_dim=DIM * DIM)
    j, p = _pair(tmp_path, "RESCALModel")
    assert p._score_func.relation_dim == DIM
    head, rel, tail = np.array([0, 1]), np.array([0, 1, 2]), np.array([2, 3])
    (h, r, t, score, _), = _assert_link_matches(
        p, j, 6, head=head, rel=rel, tail=tail, exec_mode="all")
    hh, rr, tt = (x.ravel() for x in np.meshgrid(head, rel, tail,
                                                 indexing="ij"))
    ref = _score_loop("RESCAL", ent, rel_emb, hh, rr, tt)
    order = np.argsort(-ref, kind="stable")[:6]
    np.testing.assert_allclose(score, ref[order], rtol=2e-4, atol=2e-4)


def test_link_predict_triplet_wise_and_logsigmoid(tmp_path):
    rng = np.random.default_rng(4)
    ent, rel_emb = _save_ckpt(tmp_path, rng)
    j, p = _pair(tmp_path, "TransE_l2Model", gamma=12.0)
    h, r, t = (rng.integers(0, n, 20) for n in (N_ENT, N_REL, N_ENT))
    (rh, rr, rt, score, _), = _assert_link_matches(
        p, j, 7, head=h, rel=r, tail=t, exec_mode="triplet_wise",
        sfunc="logsigmoid")
    ref = _score_loop("TransE_l2", ent, rel_emb, h, r, t)
    ref = np.log(1.0 / (1.0 + np.exp(-ref)))
    order = np.argsort(-ref, kind="stable")[:7]
    np.testing.assert_allclose(score, ref[order], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(rh, h[order])


@pytest.mark.parametrize("mode", ["batch_head", "batch_rel", "batch_tail"])
def test_link_predict_batch_modes(tmp_path, mode):
    rng = np.random.default_rng(5)
    _save_ckpt(tmp_path, rng)
    j, p = _pair(tmp_path, "DistMultModel")
    head, rel, tail = np.array([0, 1, 2]), np.array([0, 1]), \
        np.array([3, 4, 5, 6])
    res = _assert_link_matches(p, j, 3, gamma=0.0, head=head, rel=rel,
                               tail=tail, exec_mode=mode)
    fixed = {"batch_head": (0, head), "batch_rel": (1, rel),
             "batch_tail": (2, tail)}[mode]
    assert len(res) == len(fixed[1])
    for i, element in enumerate(res):
        assert (element[fixed[0]] == fixed[1][i]).all()


def test_link_predict_exclude_and_mask(tmp_path):
    rng = np.random.default_rng(6)
    _save_ckpt(tmp_path, rng)
    j, p = _pair(tmp_path, "TransE_l2Model", gamma=12.0)
    head, rel, tail = np.arange(8), np.arange(3), np.arange(8, 20)
    kw = dict(head=head, rel=rel, tail=tail, exec_mode="all")
    res = _link(p, 12, **kw)
    graph = tuple(x[:6] for x in res[0][:3])
    j.attach_graph(graph)
    p.attach_graph(graph)
    for mode, k in (("mask", 12), ("exclude", 6)):
        (h, r, t, score, mask), = _link(p, k, exclude_mode=mode, **kw)
        (wh, wr, wt, ws, wmask), = _link(j, k, exclude_mode=mode, **kw)
        for a, b in ((h, wh), (r, wr), (t, wt)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(score, ws, rtol=1e-5, atol=1e-5)
        if mode == "mask":
            np.testing.assert_array_equal(mask, wmask)
            assert mask[:6].all() and not mask[6:].any()
        else:
            assert mask is None and len(h) == 6
            assert not p.graph.contains(h, r, t).any()
            np.testing.assert_array_equal(h, res[0][0][6:12])
    p2 = P.TransE_l2Model(device="cpu", gamma=12.0)
    p2.load(str(tmp_path))
    with pytest.raises(ValueError, match="attach_graph"):
        p2.link_predict(head=head, rel=rel, tail=tail,
                        exclude_mode="exclude")
    with pytest.raises(ValueError, match="unknown exclude_mode"):
        p.link_predict(head=head, rel=rel, tail=tail, exclude_mode="drop")


def test_link_predict_exclude_escalates_beyond_4k(tmp_path):
    rng = np.random.default_rng(7)
    _save_ckpt(tmp_path, rng)
    j, p = _pair(tmp_path, "DistMultModel")
    head, rel, tail = np.arange(10), np.arange(2), np.arange(10, 25)
    kw = dict(head=head, rel=rel, tail=tail, exec_mode="all")
    fh, fr, ft, _, _ = _link(p, 10 * 2 * 15, **kw)[0]
    for m in (j, p):
        m.attach_graph((fh[:11], fr[:11], ft[:11]))
    (h, r, t, score, _), = _link(p, 2, exclude_mode="exclude", **kw)
    (wh, wr, wt, ws, _), = _link(j, 2, exclude_mode="exclude", **kw)
    np.testing.assert_array_equal(h, fh[11:13])
    np.testing.assert_array_equal(t, ft[11:13])
    np.testing.assert_array_equal(np.stack([h, r, t]), np.stack([wh, wr, wt]))
    np.testing.assert_allclose(score, ws, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# embed_sim


@pytest.mark.parametrize("embed_type,sfunc,mode", [
    ("entity", "cosine", "all"), ("relation", "l2", "pairwise"),
    ("entity", "dot", "bcast"), ("relation", "ext_jaccard", "all"),
    ("entity", "l1", "bcast")])
def test_embed_sim_modes(tmp_path, embed_type, sfunc, mode):
    rng = np.random.default_rng(8)
    ent, rel_emb = _save_ckpt(tmp_path, rng)
    j, p = _pair(tmp_path, "TransE_l2Model", gamma=12.0)
    left, right = np.array([0, 1, 2, 3]), np.array([4, 5, 1, 3])
    kw = dict(left=left, right=right, embed_type=embed_type, sfunc=sfunc,
              bcast=mode == "bcast", pair_ws=mode == "pairwise")
    got = p.embed_sim(topk=3, **kw)
    want = j.embed_sim(topk=ALL, **kw)
    assert len(got) == len(want) == (4 if mode == "bcast" else 1)
    for g, w in zip(got, want):
        assert_top_matches(g, w, 3)
    if (embed_type, sfunc) == ("entity", "cosine"):
        le, re_ = ent[left], ent[right]
        ref = ((le @ re_.T) / (np.linalg.norm(le, axis=1)[:, None]
                               * np.linalg.norm(re_, axis=1)[None, :]))
        order = np.argsort(-ref.ravel(), kind="stable")[:3]
        np.testing.assert_allclose(got[0][2], ref.ravel()[order],
                                   rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="'entity' or 'relation'"):
        p.embed_sim(embed_type="projection")


# ---------------------------------------------------------------------------
# GNNModel, attaching a dataset, loading


@pytest.mark.parametrize("name", ["TransE", "TransE_l2", "TransE_l1",
                                  "DistMult"])
def test_gnn_model_load_and_predict(tmp_path, name):
    rng = np.random.default_rng(9)
    _save_ckpt(tmp_path, rng)
    j, p = _pair(tmp_path, "GNNModel", model_name=name, gamma=5.0)
    _assert_link_matches(p, j, 2, gamma=5.0, head=np.array([0, 1]),
                         rel=np.array([0]), tail=np.array([2, 3]))


def test_gnn_model_refuses_other_families():
    with pytest.raises(ValueError, match="TransE_l1, TransE_l2"):
        P.GNNModel(device="cpu", model_name="RotatE")


def test_attach_graph_from_dataset(tmp_path):
    from dglke_tpu.data.dataset import synthetic_dataset as jax_synthetic
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    rng = np.random.default_rng(10)
    _save_ckpt(tmp_path, rng)
    j, p = _pair(tmp_path, "TransE_l2Model", gamma=12.0)
    p.attach_graph(synthetic_dataset(n_entities=N_ENT, n_relations=N_REL,
                                     n_train=64, seed=0))
    j.attach_graph(jax_synthetic(n_entities=N_ENT, n_relations=N_REL,
                                 n_train=64, seed=0))
    h, r, t = p.graph.edges
    assert p.graph.contains(h[:10], r[:10], t[:10]).all()
    for a, b in zip(p.graph.edges, j.graph.edges):
        np.testing.assert_array_equal(a, b)


def test_load_prefixed_trainer_checkpoint(tmp_path):
    ent = np.random.default_rng(0).normal(size=(10, 8)).astype(np.float32)
    rel = np.random.default_rng(1).normal(size=(3, 8)).astype(np.float32)
    np.save(tmp_path / "fakekg_TransE_l2_entity.npy", ent)
    np.save(tmp_path / "fakekg_TransE_l2_relation.npy", rel)
    np.save(tmp_path / "fakekg_TransE_l2_entity_state.npy",
            np.zeros(10, np.float32))
    np.save(tmp_path / "fakekg_TransE_l2_relation_state.npy",
            np.zeros(3, np.float32))
    m = P.TransE_l2Model(device="cpu", gamma=5.0)
    m.load(str(tmp_path))
    assert m.entity_embed.device.type == "cpu"
    np.testing.assert_array_equal(m.entity_embed.numpy(), ent)
    np.testing.assert_array_equal(m.relation_embed.numpy(), rel)
    assert (m.num_entity, m.num_rel, m.model_name) == (10, 3, "TransE_l2")


def test_load_ambiguous_prefixed_checkpoint_raises(tmp_path):
    for prefix in ("a_TransE_l2", "b_TransE_l2"):
        np.save(tmp_path / f"{prefix}_entity.npy",
                np.zeros((4, 8), np.float32))
        np.save(tmp_path / f"{prefix}_relation.npy",
                np.zeros((2, 8), np.float32))
    m = P.TransE_l2Model(device="cpu", gamma=5.0)
    with pytest.raises(FileNotFoundError, match="ambiguous"):
        m.load(str(tmp_path))


def test_inference_only_methods_raise():
    m = P.DistMultModel(device="cpu")
    for call in (lambda: m.save("x"), m.fit, m.eval,
                 lambda: P.BasicGEModel(device="cpu").load("x")):
        with pytest.raises(NotImplementedError):
            call()


@pytest.mark.parametrize("device", [None, -1, 0, "cuda"])
@pytest.mark.parametrize("cls", ["TransE_l2Model", "RESCALModel", "GNNModel"])
def test_defaults_to_the_card_and_raises_without_one(monkeypatch, cls,
                                                     device):
    """Without a card the classes raise unless device="cpu"; the JAX
    package's gpu id -1 (or any int) does not select the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {} if device is None else dict(device=device)
    with pytest.raises(RuntimeError, match="CUDA device"):
        getattr(P, cls)(**kw)
    assert getattr(P, cls)(device="cpu")._device.type == "cpu"
