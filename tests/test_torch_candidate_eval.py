"""dglke_tpu_torch's candidate-list eval (the wikikg90M protocol) and its
ogb loaders against the JAX package's, on the same numpy tables.

Scores of every family (TransR's per-row projection of the candidates
included) agree with the JAX package's within fp32 rounding, and Valid
ranks (the answer counts itself: best rank 2) and Test top-10 positions
are identical.  Exact ties come from a candidate id listed twice in a
row: the port scores both copies the same, bit for bit, while XLA's CPU
dot may round them apart by an ulp (so the JAX package's own result there
depends on rounding); on the same score matrix the port's ranks and top-10
equal the JAX package's formulas (sum(s >= s[ans]) + 1 and lax.top_k,
lower position first).  The `ogb` package is
not installed here, so the loaders are driven by small fake
`ogb.linkproppred` / `ogb.lsc` modules, as tests/test_ogb_loaders.py does
for the JAX package.
"""

import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.data.dataset import get_dataset as jax_get_dataset
from dglke_tpu.models.ke_model import KEModel as JaxModel
from dglke_tpu.trainer import CandidateEvalSampler as JaxCandSampler
from dglke_tpu.trainer import evaluate_candidates as jax_eval_candidates
from dglke_tpu_torch.cli.eval import main as eval_main
from dglke_tpu_torch.cli.train import main as train_main
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import KGDataset, get_dataset
from dglke_tpu_torch.models.ke_model import (
    KEModel,
    candidate_ranks,
    candidate_top,
)
from dglke_tpu_torch.trainer import (
    CandidateEvalSampler,
    evaluate_candidates,
    evaluate_with_samplers,
)
from dglke_tpu_torch.utils.convert import state_from_numpy

torch.set_num_threads(2)

N_ENT, N_REL, DIM, N_Q, N_CAND = 60, 4, 8, 23, 12
QUIET = lambda *a: None  # noqa: E731
FAMILIES = {"TransE_l2": {}, "TransE_l1": {}, "TransR": {}, "DistMult": {},
            "ComplEx": {}, "RESCAL": {}, "RotatE": dict(double_ent=True),
            "SimplE": {}}
# scores: the same formulas in both packages, fp32 rounding apart
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-5


def _edges(seed=0, with_ans=True, dup=True):
    """A candidate split of distinct candidates; with dup, rows 0, 3, 6,
    ... list their answer's id twice (after the answer, so the answer keeps
    the lower position) and rows 1, 4, ... their first candidate twice:
    exact ties."""
    rng = np.random.RandomState(seed)
    hr = np.stack([rng.randint(0, N_ENT, N_Q),
                   rng.randint(0, N_REL, N_Q)], axis=1)
    cand = np.stack([rng.permutation(N_ENT)[:N_CAND] for _ in range(N_Q)])
    ans = rng.randint(0, N_CAND - 1, N_Q)
    for i in range(N_Q if dup else 0):
        if i % 3 == 0:
            cand[i, N_CAND - 1] = cand[i, ans[i]]
        elif i % 3 == 1:
            cand[i, N_CAND - 1] = cand[i, 0]
    d = {"hr": hr, "t_candidate": cand}
    if with_ans:
        d["t_correct_index"] = ans
    return {"h,r->t": d}


def _pair(name, emb_dtype="float32"):
    kw = dict(model_name=name, hidden_dim=DIM, gamma=4.0, **FAMILIES[name])
    jm = JaxModel(JaxConfig(**kw, emb_dtype=emb_dtype), N_ENT, N_REL)
    pm = KEModel(KGEConfig(**kw, emb_dtype=emb_dtype), N_ENT, N_REL,
                 device="cpu")
    jstate = jax.device_get(jm.init_state(jax.random.PRNGKey(2)))
    return jm, jstate, pm, state_from_numpy(jstate, device="cpu")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_candidate_scores_match(name):
    jm, jstate, pm, pstate = _pair(name)
    d = _edges()["h,r->t"]
    hr, cand = d["hr"].astype(np.int32), d["t_candidate"].astype(np.int32)
    want = np.asarray(jm.candidate_scores(jstate, hr[:, 0], hr[:, 1], cand))
    got = pm.candidate_scores(pstate, torch.from_numpy(hr[:, 0]),
                              torch.from_numpy(hr[:, 1]),
                              torch.from_numpy(cand))
    assert got.dtype == torch.float32 and got.shape == (N_Q, N_CAND)
    np.testing.assert_allclose(got.numpy(), want, rtol=SCORE_RTOL,
                               atol=SCORE_ATOL)
    # a candidate listed twice scores the same, bit for bit
    ans = torch.from_numpy(d["t_correct_index"])
    rows = torch.arange(0, N_Q, 3)
    assert torch.equal(got[rows, N_CAND - 1], got[rows, ans[rows].long()])
    assert torch.equal(got[rows + 1, N_CAND - 1], got[rows + 1, 0])

    # on these scores, the port's ranks and top-10 are the JAX package's
    # formulas', ties included
    s = jnp.asarray(got.numpy())
    jrank = jnp.sum(s >= jnp.take_along_axis(s, jnp.asarray(
        d["t_correct_index"])[:, None], axis=1), axis=1) + 1
    np.testing.assert_array_equal(candidate_ranks(got, ans).numpy(),
                                  np.asarray(jrank))
    assert int(candidate_ranks(got, ans)[rows].min()) >= 3
    np.testing.assert_array_equal(candidate_top(got).numpy(),
                                  np.asarray(jax.lax.top_k(s, 10)[1]))


def test_transr_candidates_projected_by_their_row():
    """TransR: score = gamma - L1(h P_r + r - c P_r), each row's
    candidates projected by that row's own relation matrix (float64
    numpy)."""
    _, jstate, pm, pstate = _pair("TransR")
    d = _edges()["h,r->t"]
    hr, cand = d["hr"], d["t_candidate"]
    got = pm.candidate_scores(pstate, torch.from_numpy(hr[:, 0]),
                              torch.from_numpy(hr[:, 1]),
                              torch.from_numpy(cand)).numpy()
    ent = np.asarray(jstate.entity.emb, np.float64)
    rel = np.asarray(jstate.relation.emb, np.float64)
    proj = np.asarray(jstate.projection.emb, np.float64)
    for i in range(N_Q):
        p = proj[hr[i, 1]].reshape(DIM, DIM)
        want = 4.0 - np.abs(ent[hr[i, 0]] @ p + rel[hr[i, 1]]
                            - ent[cand[i]] @ p).sum(1)
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_valid_ranks_and_test_top10_identical(name, tmp_path):
    """Valid metrics and the Test pkl (top-10 and answers) equal the JAX
    package's, on distinct candidates."""
    jm, jstate, pm, pstate = _pair(name)
    edges = _edges(dup=False)
    want = jax_eval_candidates(jm, jstate, JaxCandSampler(edges, 8),
                               mode="Valid", log=QUIET)
    got = evaluate_candidates(pm, pstate, CandidateEvalSampler(edges, 8),
                              mode="Valid", log=QUIET)
    assert got == want
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    jax_eval_candidates(jm, jstate, JaxCandSampler(edges, 8), mode="Test",
                        save_path=str(jdir), log=QUIET)
    assert evaluate_candidates(pm, pstate, CandidateEvalSampler(edges, 8),
                               mode="Test", save_path=str(pdir),
                               log=QUIET) is None
    with open(jdir / "test_0.pkl", "rb") as f:
        jpkl = pickle.load(f)["h,r->t"]
    with open(pdir / "test_0.pkl", "rb") as f:
        ppkl = pickle.load(f)["h,r->t"]
    assert set(ppkl) == set(jpkl) == {"t_pred_top10", "t_correct_index"}
    for k in jpkl:
        assert ppkl[k].dtype == jpkl[k].dtype
        np.testing.assert_array_equal(ppkl[k], jpkl[k])


def test_exact_ties_rank_and_order():
    """A row whose answer's id appears twice ranks the copy beside the
    answer; a duplicated top candidate keeps the lower position first."""
    scores = torch.tensor([[0.5, 2.0, 1.0, 2.0, 0.5],
                           [3.0, 1.0, 1.0, 1.0, 0.0]])
    ranks = candidate_ranks(scores, torch.tensor([1, 2]))
    assert ranks.tolist() == [3, 5]
    assert candidate_ranks(scores, torch.tensor([1, 0])).min() == 2
    top = candidate_top(scores, top=4)
    assert top.tolist() == [[1, 3, 2, 0], [0, 1, 2, 3]]
    assert candidate_top(scores).shape == (2, 5)     # K < 10: K columns
    want = jax.lax.top_k(jnp.asarray(scores.numpy()), 4)[1]
    np.testing.assert_array_equal(top.numpy(), np.asarray(want))


def test_bf16_tables_score_in_fp32():
    """The port upcasts a bf16 table's rows and scores in fp32 (the JAX
    package scores them in bf16): the scores equal those of the fp32
    table holding the same values."""
    _, jstate, pm, pstate = _pair("TransE_l2", emb_dtype="bfloat16")
    assert pstate.entity.emb.dtype == torch.bfloat16
    _, _, pm32, _ = _pair("TransE_l2")
    up = state_from_numpy(jax.device_get(jstate), device="cpu")
    up.entity.emb = up.entity.emb.float()
    up.relation.emb = up.relation.emb.float()
    d = _edges()["h,r->t"]
    args = [torch.from_numpy(x) for x in (d["hr"][:, 0], d["hr"][:, 1],
                                          d["t_candidate"])]
    got = pm.candidate_scores(pstate, *args)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, pm32.candidate_scores(up, *args),
                               rtol=0, atol=0)


def test_valid_hook_routes_candidate_sampler():
    _, _, pm, pstate = _pair("DistMult")
    sampler = CandidateEvalSampler(_edges(), 8)
    assert (evaluate_with_samplers(pm, pstate, [sampler], phase="Valid",
                                   log=QUIET)
            == evaluate_candidates(pm, pstate, sampler, mode="Valid",
                                   log=QUIET))
    with pytest.raises(ValueError, match="answer indices"):
        evaluate_candidates(pm, pstate,
                            CandidateEvalSampler(_edges(with_ans=False), 8),
                            mode="Valid", log=QUIET)


def test_test_pkl_without_answers_and_empty(tmp_path):
    _, _, pm, pstate = _pair("TransE_l2")
    evaluate_candidates(pm, pstate,
                        CandidateEvalSampler(_edges(with_ans=False), 5),
                        mode="Test", save_path=str(tmp_path), log=QUIET)
    with open(tmp_path / "test_0.pkl", "rb") as f:
        out = pickle.load(f)
    assert set(out["h,r->t"]) == {"t_pred_top10"}
    top = out["h,r->t"]["t_pred_top10"]
    assert top.shape == (N_Q, 10) and top.dtype == np.int32
    assert (0 <= top).all() and (top < N_CAND).all()
    empty = {"h,r->t": {"hr": np.zeros((0, 2), np.int64),
                        "t_candidate": np.zeros((0, 4), np.int64)}}
    evaluate_candidates(pm, pstate, CandidateEvalSampler(empty, 5),
                        mode="Test", save_path=str(tmp_path), log=QUIET)
    with open(tmp_path / "test_0.pkl", "rb") as f:
        assert pickle.load(f)["h,r->t"]["t_pred_top10"].shape == (0, 4)


# ---------------------------------------------------------------------------
# the ogb loaders, with fake ogb modules


def _install_fake_ogb(monkeypatch, reltype_shape="2d"):
    rng = np.random.RandomState(0)

    def split(n):
        return {"head": rng.randint(0, N_ENT, n),
                "relation": rng.randint(0, N_REL, n),
                "tail": rng.randint(0, N_ENT, n)}

    class FakeLinkPropPredDataset:
        def __init__(self, name, root):
            assert name in ("ogbl-wikikg2", "ogbl-biokg"), name
            self.root = root

        def get_edge_split(self):
            return {"train": split(200), "valid": split(40),
                    "test": split(40)}

        def __getitem__(self, i):
            assert i == 0
            rel = np.arange(200) % N_REL
            return {"num_nodes": N_ENT,
                    "edge_reltype": rel[:, None] if reltype_shape == "2d"
                    else rel}

    class FakeWikiKG90MDataset:
        def __init__(self, root):
            r = np.random.RandomState(1)
            self.train_hrt = np.stack([r.randint(0, N_ENT, 400),
                                       r.randint(0, N_REL, 400),
                                       r.randint(0, N_ENT, 400)], axis=1)
            self.num_entities = N_ENT
            self.num_relations = N_REL
            self.valid_dict = _edges(seed=1)
            self.test_dict = _edges(seed=2, with_ans=False)

    ogb = types.ModuleType("ogb")
    linkproppred = types.ModuleType("ogb.linkproppred")
    linkproppred.LinkPropPredDataset = FakeLinkPropPredDataset
    lsc = types.ModuleType("ogb.lsc")
    lsc.WikiKG90MDataset = FakeWikiKG90MDataset
    ogb.linkproppred, ogb.lsc = linkproppred, lsc
    for name, mod in (("ogb", ogb), ("ogb.linkproppred", linkproppred),
                      ("ogb.lsc", lsc)):
        monkeypatch.setitem(sys.modules, name, mod)


@pytest.mark.parametrize("reltype_shape", ["2d", "1d"])
@pytest.mark.parametrize("name", ["wikikg2", "biokg"])
def test_load_ogb_matches_jax(monkeypatch, tmp_path, name, reltype_shape):
    _install_fake_ogb(monkeypatch, reltype_shape)
    ds = get_dataset(str(tmp_path), name, "built_in")
    _install_fake_ogb(monkeypatch, reltype_shape)
    jds = jax_get_dataset(str(tmp_path), name, "built_in")
    assert isinstance(ds, KGDataset)
    assert (ds.n_entities, ds.n_relations) == (jds.n_entities,
                                               jds.n_relations) == (N_ENT,
                                                                    N_REL)
    for split in ("train", "valid", "test"):
        for a, b in zip(getattr(ds, split), getattr(jds, split)):
            assert a.dtype == np.int64
            np.testing.assert_array_equal(a, b)
    assert ds.valid_dict is None and ds.test_dict is None


@pytest.mark.parametrize("name", ["wikikg2", "biokg", "wikikg90M"])
def test_load_without_ogb_raises(monkeypatch, tmp_path, name):
    monkeypatch.setitem(sys.modules, "ogb", None)
    monkeypatch.setitem(sys.modules, "ogb.linkproppred", None)
    monkeypatch.setitem(sys.modules, "ogb.lsc", None)
    with pytest.raises(ImportError, match="ogb"):
        get_dataset(str(tmp_path), name, "built_in")


def test_load_wiki90m(monkeypatch, tmp_path):
    _install_fake_ogb(monkeypatch)
    ds = get_dataset(str(tmp_path), "wikikg90M", "built_in")
    assert (ds.n_entities, ds.n_relations) == (N_ENT, N_REL)
    assert len(ds.train[0]) == 400 and ds.valid is None
    assert ds.valid_dict["h,r->t"]["t_candidate"].shape == (N_Q, N_CAND)
    assert "t_correct_index" not in ds.test_dict["h,r->t"]


def test_wiki90m_train_and_eval_cli(monkeypatch, tmp_path, capsys):
    """The wikikg90M protocol through both CLIs: candidate Valid metrics
    during training, the top-10 test_0.pkl at its end; the eval CLI writes
    the same pkl from the checkpoint."""
    _install_fake_ogb(monkeypatch)
    save_root = str(tmp_path / "ckpts")
    assert train_main([
        "--model_name", "TransE_l2", "--dataset", "wikikg90M",
        "--data_path", str(tmp_path), "--format", "built_in",
        "--batch_size", "32", "--neg_sample_size", "8",
        "--hidden_dim", "16", "--gamma", "5.0", "--lr", "0.2",
        "--max_step", "40", "--log_interval", "20",
        "--valid", "--eval_interval", "20", "--test",
        "--batch_size_eval", "5", "--save_path", save_root,
        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("[0]Valid average MRR") == 2
    assert "device-resident pipeline: 10 steps a group" in out
    ckpt = os.path.join(save_root, "TransE_l2_wikikg90M_0")
    pkl = os.path.join(ckpt, "test_0.pkl")
    with open(pkl, "rb") as f:
        top = pickle.load(f)["h,r->t"]["t_pred_top10"]
    assert top.shape == (N_Q, 10)
    os.remove(pkl)
    assert eval_main(["--dataset", "wikikg90M", "--data_path",
                      str(tmp_path), "--format", "built_in",
                      "--model_path", ckpt, "--batch_size_eval", "5",
                      "--device", "cpu"]) == 0
    with open(pkl, "rb") as f:
        np.testing.assert_array_equal(
            pickle.load(f)["h,r->t"]["t_pred_top10"], top)
