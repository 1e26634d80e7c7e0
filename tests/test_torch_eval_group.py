"""dglke_tpu_torch's grouped eval (trainer._mega_eval, _sampled_eval,
candidate_outputs over models/eval_step.py) against the JAX package's
evaluate / evaluate_candidates (_mega_eval + make_eval_megastep,
make_sampled_eval_superstep, make_candidate_megastep) on the same numpy
tables and the same eval batches: integer ranks identical.

The train split plants hubs, (h, r) pairs and (r, t) pairs with 12, 30
and 70 true answers, so that the batches' pow2 filter widths fall in four
buckets (8, 16, 32, 128); a monkeypatched small _MEGA_BUDGET (in both
packages) cuts buckets into several chunks, each bucket then making its
calls in one shape.  Raw (unfiltered) ranks may differ by one at the true
entity's own tie, the recorded deliberate difference
(tests/test_torch_eval.py); Test-mode top-10 positions may differ only at
a near tie of the scores.  On the CPU every call runs eagerly: no graph.
The tail groups and chunks are padded to their bucket's call shape only
where the calls run as CUDA graphs; the "graph" shapes cases batch as a
card does (EvalCalls.on_graphs patched true) and still run every call
eagerly (EvalCalls._call patched to the group function).
"""

import pickle

import numpy as np
import pytest
import torch

import jax

import dglke_tpu.trainer as jax_trainer
from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.data.dataset import KGDataset as JaxDataset
from dglke_tpu.models.ke_model import KEModel as JaxModel
from dglke_tpu.trainer import CandidateEvalSampler as JaxCandSampler
import dglke_tpu_torch.trainer as pt_trainer
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import KGDataset
from dglke_tpu_torch.models.eval_step import EvalCalls
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.trainer import (
    EVAL_GROUP,
    CandidateEvalSampler,
    evaluate,
    evaluate_candidates,
)
from dglke_tpu_torch.utils.convert import state_from_numpy

torch.set_num_threads(2)

N_ENT, N_REL, DIM, B = 160, 4, 8, 4
QUIET = lambda *a: None  # noqa: E731
FAMILIES = {"TransE_l2": {}, "RotatE": dict(double_ent=True),
            "TransR": {}, "RESCAL": {}}
# a budget just under 64 batches of width 8: chunks of 32 batches in every
# bucket (bucket 8 takes two), while one slab (2 x _MEGA_BUDGET filter
# bytes) still holds a whole mode of the split
SMALL_BUDGET = B * 8 * 5 * 64 - 1
# a near tie of two scores: within this of each other, relative to
# |score| + gamma (the card's and the CPU's summation orders differ there)
TIE_RTOL = 1e-6


def _hub_dataset():
    """Random triples plus hubs: (h, r) -> 12 / 30 / 70 tails and (r, t)
    -> 12 / 30 / 70 heads.  The test split is 160 random triples, then 8
    triples of each hub's (h, r) and 8 of its (r, t) side, so that batches
    of 4 fall in the buckets 8, 16, 32 and 128 (over 32 batches of a mode
    in bucket 8)."""
    rng = np.random.RandomState(5)
    parts = [(rng.randint(0, N_ENT, 600), rng.randint(0, N_REL, 600),
              rng.randint(0, N_ENT, 600))]
    for i, n in enumerate((12, 30, 70)):
        many = rng.choice(N_ENT, n, replace=False)
        parts.append((np.full(n, i), np.full(n, i), many))
        parts.append((many, np.full(n, i + 1), np.full(n, 100 + i)))
    h, r, t = (np.concatenate([p[k] for p in parts]).astype(np.int64)
               for k in range(3))
    pick, at = [rng.choice(600, 160, replace=False)], 600
    for n in (12, 30, 70):
        pick += [at + np.arange(8), at + n + np.arange(8)]
        at += 2 * n
    pick = np.concatenate(pick)
    test = tuple(x[pick] for x in (h, r, t))
    kw = dict(name="hubs", n_entities=N_ENT, n_relations=N_REL,
              train=(h, r, t), test=test)
    return JaxDataset(**kw), KGDataset(**kw)


JDS, PDS = _hub_dataset()


def _pair(name, **over):
    kw = dict(model_name=name, hidden_dim=DIM, gamma=4.0,
              batch_size_eval=B, **FAMILIES[name], **over)
    jcfg, pcfg = JaxConfig(**kw), KGEConfig(**kw)
    jm = JaxModel(jcfg, N_ENT, N_REL)
    pm = KEModel(pcfg, N_ENT, N_REL, device="cpu")
    jstate = jax.device_get(jm.init_state(jax.random.PRNGKey(3)))
    return jcfg, jm, jstate, pcfg, pm, state_from_numpy(jstate,
                                                        device="cpu")


def _ranks(mp, module, fn):
    """The rank array ``fn`` hands the module's combine_rank_metrics."""
    seen = []
    real = module.combine_rank_metrics

    def spy(ranks, *a, **k):
        seen.append(np.asarray(ranks))
        return real(ranks, *a, **k)

    mp.setattr(module, "combine_rank_metrics", spy)
    metrics = fn()
    mp.setattr(module, "combine_rank_metrics", real)
    (ranks,) = seen
    return metrics, ranks


def _graph_shapes(mp):
    """Batch the port's eval as on a card, where the calls run as CUDA
    graphs (each tail group or chunk padded to its bucket's call shape),
    while each call still runs its group function eagerly."""
    def eager(self, state, static, fn, args):
        self.keys[self._key(state, static, args)] += 1
        return fn(*args)

    mp.setattr(EvalCalls, "on_graphs", lambda self, state: True)
    mp.setattr(EvalCalls, "_call", eager)


def _both(monkeypatch, name, budget=None, shapes="eager", **over):
    """(JAX ranks, port ranks, port metrics, JAX metrics, port model) of
    the test split, filtered or not as ``over`` says; ``shapes`` "graph"
    batches the port's eval as a card does (_graph_shapes)."""
    jcfg, jm, jstate, pcfg, pm, pstate = _pair(name, **over)
    with monkeypatch.context() as mp:
        if budget is not None:
            mp.setattr(jax_trainer, "_MEGA_BUDGET", budget)
            mp.setattr(pt_trainer, "_MEGA_BUDGET", budget)
        jmet, want = _ranks(mp, jax_trainer, lambda: jax_trainer.evaluate(
            jcfg, JDS, jm, jstate, "test", log=QUIET))
        if shapes == "graph":
            _graph_shapes(mp)
        logs = []
        pmet, got = _ranks(mp, pt_trainer, lambda: evaluate(
            pcfg, PDS, pm, pstate, "test", log=logs.append))
    assert (shapes == "graph") == any("CUDA graphs" in x for x in logs)
    return want, got, pmet, jmet, pm


def _widths(filtered=True):
    """Each test batch's pow2 filter width, both modes."""
    from dglke_tpu_torch.data.sampler import EvalSampler, FilterIndex
    fi = FilterIndex(PDS) if filtered else None
    return [b["filter_ids"].shape[1] if filtered else 8
            for mode in ("head", "tail")
            for b in EvalSampler(PDS, "test", B, mode, fi)]


def test_hubs_spread_the_filter_widths():
    assert set(_widths()) >= {8, 16, 32, 128}


@pytest.mark.parametrize("filtered", [True, False], ids=["filtered", "raw"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_full_entity_ranks_identical(monkeypatch, name, filtered):
    want, got, pmet, jmet, pm = _both(monkeypatch, name,
                                      no_eval_filter=not filtered)
    assert got.shape == want.shape == (2 * len(PDS.test[0]),)
    if filtered:
        np.testing.assert_array_equal(got, want)
        assert pmet == jmet
    else:
        # the true entity's own tie (no other entity's row equals it): one
        # rank step at most
        assert np.abs(got - want).max() <= 1
    # one group call a (bucket, chunk): every batch of the split ranked
    calls = sum(pm.eval_calls.keys.values())
    assert 0 < calls < len(_widths(filtered)) / 2


@pytest.mark.parametrize("shapes", ["graph", "eager"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_multi_chunk_buckets_identical_one_shape_each(monkeypatch, name,
                                                      shapes):
    """A small _MEGA_BUDGET cuts the wide buckets into several chunks in
    both packages: the ranks stay the JAX package's and the port's own at
    the full budget.  Batched for graphs, every bucket makes all its calls
    under one memo key (one graph shape on a card); eagerly, the tail
    chunk of bucket 8 takes the pow2 ladder (a second, smaller shape)."""
    want, got, _, _, pm = _both(monkeypatch, name, budget=SMALL_BUDGET,
                                shapes=shapes)
    np.testing.assert_array_equal(got, want)
    _, whole, _, _, _ = _both(monkeypatch, name)
    np.testing.assert_array_equal(got, whole)
    keys = pm.eval_calls.keys
    by_bucket = {}
    for key in keys:
        kind, phase, neg_head, ins = key[:4]
        assert (kind, phase) == ("full", "Test")
        by_bucket.setdefault((neg_head, ins[3][0][-1]), []).append(
            ins[0][0][0])
    assert {f for _, f in by_bucket} >= {8, 16, 32, 128}
    if shapes == "graph":
        assert all(len(g) == 1 for g in by_bucket.values()), by_bucket
    else:
        # bucket 8: chunks of 32 batches, the tail under 32 on the ladder
        assert all(sorted(by_bucket[(nh, 8)])[1:] == [EVAL_GROUP]
                   and min(by_bucket[(nh, 8)]) < EVAL_GROUP
                   for nh in (True, False)), by_bucket
    # the wide buckets took several chunks: more calls than buckets
    assert sum(keys.values()) > len(by_bucket)


def test_group_ranks_equal_batch_by_batch():
    """eval_group_ranks on a [g, B] group: the ranks of eval_ranks on each
    batch alone."""
    from dglke_tpu_torch.data.sampler import EvalSampler, FilterIndex
    _, _, _, _, pm, pstate = _pair("TransE_l2")
    batches = list(EvalSampler(PDS, "test", B, "tail", FilterIndex(PDS)))
    f = max(b["filter_ids"].shape[1] for b in batches)

    def widen(x):
        return np.pad(x, ((0, 0), (0, f - x.shape[1])))

    group = {k: torch.from_numpy(np.stack([b[k] for b in batches]))
             for k in ("h", "r", "t")}
    fid, fm = (torch.from_numpy(np.stack([widen(b[k]) for b in batches]))
               for k in ("filter_ids", "filter_mask"))
    got = pm.eval_group_ranks(pstate, group["h"], group["r"], group["t"],
                              fid, fm, neg_head=False)
    for i, b in enumerate(batches):
        alone = pm.eval_ranks(
            pstate, *(torch.from_numpy(b[k]) for k in
                      ("h", "r", "t", "filter_ids", "filter_mask")),
            neg_head=False)
        assert torch.equal(got[i], alone)


def _sampled_twins(cfg):
    """Per real row of the sampled eval, in evaluate's order: the kept
    candidates that are the true entity itself, a tie up to rounding (the
    sampled negatives; with neg_deg_sample also the batch's other real
    rows' own entities).  The tables' rows are distinct."""
    from dglke_tpu_torch.data.sampler import EvalSampler
    out = []
    for mode in ("head", "tail"):
        for b in EvalSampler(PDS, "test", B, mode, None, seed=cfg.seed,
                             neg_sample_size=cfg.neg_sample_size_eval,
                             neg_deg_sample=True):
            true = b["h"] if mode == "head" else b["t"]
            nv = b["n_valid"]
            own = (true[:nv, None] == true[None, :nv]).sum(1) - 1
            out.append(own + (b["neg"][None, :] == true[:nv, None]).sum(1))
    return np.concatenate(out)


@pytest.mark.parametrize("shapes", ["graph", "eager"])
@pytest.mark.parametrize("deg", [False, True], ids=["filtered_keep",
                                                    "raw_deg_sample"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_sampled_ranks_identical_tail_group_padded(monkeypatch, name, deg,
                                                   shapes):
    """Sampled eval (K = 10) of 208 triples at batch 4: 52 batches a mode,
    a group of 32 and a tail group of 20, padded to 32 in the JAX package
    and where the port's calls run as graphs, ranked as 20 eagerly.
    Filtered (the neg_keep masks) the ranks are identical; with
    neg_deg_sample (unfiltered) identical but at the self-ties."""
    over = dict(neg_sample_size_eval=10, neg_deg_sample_eval=deg,
                no_eval_filter=deg)
    want, got, _, _, pm = _both(monkeypatch, name, shapes=shapes, **over)
    if deg:
        twins = _sampled_twins(pm.config)
        diff = np.abs(got - want)
        assert (diff <= twins).all() and (diff[twins == 0] == 0).all()
    else:
        np.testing.assert_array_equal(got, want)
    keys = pm.eval_calls.keys
    for key in keys:
        assert key[0] == "sampled" and key[3] == deg
    groups = sorted(key[4][0][0][0] for key in keys)   # h: [g, B]
    if shapes == "graph":       # two groups a mode in one padded shape
        assert sorted(keys.values()) == [2, 2]
        assert groups == [EVAL_GROUP] * 2
    else:
        assert sorted(keys.values()) == [1] * 4
        assert groups == [20, 20, EVAL_GROUP, EVAL_GROUP]


def _edges(n_q=100, n_cand=20, seed=0):
    rng = np.random.RandomState(seed)
    hr = np.stack([rng.randint(0, N_ENT, n_q), rng.randint(0, N_REL, n_q)],
                  axis=1)
    cand = np.stack([rng.permutation(N_ENT)[:n_cand] for _ in range(n_q)])
    ans = rng.randint(0, n_cand, n_q)
    return {"h,r->t": {"hr": hr, "t_candidate": cand,
                       "t_correct_index": ans}}


def _near_top_ties(scores, gamma, top=10):
    """Rows whose top top+1 scores hold a near tie."""
    srt = -np.sort(-scores, axis=1)[:, :top + 1]
    return ((srt[:, :-1] - srt[:, 1:])
            <= TIE_RTOL * (np.abs(srt[:, 1:]) + gamma)).any(1)


@pytest.mark.parametrize("shapes", ["graph", "eager"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_candidates_across_chunks(monkeypatch, tmp_path, name, shapes):
    """100 queries x 20 candidates at batch 8 under a small budget: chunks
    of 32 queries in both packages, the last padded to 32 in the JAX
    package and where the port's calls run as graphs, to a batch of 8
    eagerly.  Valid ranks identical; the Test top-10 identical but on rows
    with a near tie."""
    _, jm, jstate, _, pm, pstate = _pair(name)
    edges = _edges()
    with monkeypatch.context() as mp:
        mp.setattr(jax_trainer, "_MEGA_BUDGET", 2560)
        mp.setattr(pt_trainer, "_MEGA_BUDGET", 2560)
        if shapes == "graph":
            _graph_shapes(mp)
        jmet, want = _ranks(mp, jax_trainer, lambda: jax_trainer.
                            evaluate_candidates(jm, jstate,
                                                JaxCandSampler(edges, 8),
                                                mode="Valid", log=QUIET))
        pmet, got = _ranks(mp, pt_trainer, lambda: evaluate_candidates(
            pm, pstate, CandidateEvalSampler(edges, 8), mode="Valid",
            log=QUIET))
        np.testing.assert_array_equal(got, want)
        assert pmet == jmet
        for package, run, d in (
                ("jax", jax_trainer.evaluate_candidates, JaxCandSampler),
                ("port", evaluate_candidates, CandidateEvalSampler)):
            (tmp_path / package).mkdir()
            run(jm if package == "jax" else pm,
                jstate if package == "jax" else pstate, d(edges, 8),
                mode="Test", save_path=str(tmp_path / package), log=QUIET)
    top = {}
    for package in ("jax", "port"):
        with open(tmp_path / package / "test_0.pkl", "rb") as f:
            top[package] = pickle.load(f)["h,r->t"]["t_pred_top10"]
    assert top["port"].shape == top["jax"].shape == (100, 10)
    d = edges["h,r->t"]
    scores = pm.candidate_scores(
        pstate, *(torch.from_numpy(x) for x in (d["hr"][:, 0], d["hr"][:, 1],
                                                 d["t_candidate"]))).numpy()
    differ = (top["port"] != top["jax"]).any(1)
    assert not (differ & ~_near_top_ties(scores, 4.0)).any()
    # a batch a call: Valid and Test each 3 chunks of 4 batches and a tail
    # chunk of 4 batches (graphs) or of 1 (eager)
    keys = pm.eval_calls.keys
    n = 16 if shapes == "graph" else 13
    assert sorted(keys.values()) == [n, n]
    assert {k[1] for k in keys} == {"Valid", "Test"}


def _edges_twice(n_q=100, n_cand=20):
    """_edges with the answer listed twice (rows 0::4: the last candidate
    is the answer's entity) and candidate 3 listed twice (rows 1::4)."""
    edges = _edges(n_q, n_cand, seed=1)
    d = edges["h,r->t"]
    ans, cand = d["t_correct_index"], d["t_candidate"]
    ans[ans == n_cand - 1] = 0
    cand[0::4, -1] = cand[np.arange(0, n_q, 4), ans[0::4]]
    cand[1::4, -1] = cand[1::4, 3]
    return edges


@pytest.mark.parametrize("shapes", ["graph", "eager"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_candidates_listed_twice(monkeypatch, tmp_path, name, shapes):
    """Candidate lists that name a candidate twice, chunked as in
    test_candidates_across_chunks: the Valid ranks and the Test top-10 are
    exactly the protocol's (numpy) on the port's own scores of the batches
    as called (the tail batch padded with the chunk's first query); an
    answer whose copy
    scores the same ranks 3 or worse, and tied copies are listed lower
    position first; against the JAX package identical but on rows with a
    near tie (rows 0::4 always have one: the answer's copy)."""
    _, jm, jstate, _, pm, pstate = _pair(name)
    edges = _edges_twice()
    d = edges["h,r->t"]
    with monkeypatch.context() as mp:
        mp.setattr(jax_trainer, "_MEGA_BUDGET", 2560)
        mp.setattr(pt_trainer, "_MEGA_BUDGET", 2560)
        _, want = _ranks(mp, jax_trainer, lambda: jax_trainer.
                         evaluate_candidates(jm, jstate,
                                             JaxCandSampler(edges, 8),
                                             mode="Valid", log=QUIET))
        if shapes == "graph":
            _graph_shapes(mp)
        _, got = _ranks(mp, pt_trainer, lambda: evaluate_candidates(
            pm, pstate, CandidateEvalSampler(edges, 8), mode="Valid",
            log=QUIET))
        evaluate_candidates(pm, pstate, CandidateEvalSampler(edges, 8),
                            mode="Test", save_path=str(tmp_path),
                            log=QUIET)
    with open(tmp_path / "test_0.pkl", "rb") as f:
        top = pickle.load(f)["h,r->t"]["t_pred_top10"]
    # the port's scores of the batches of 8 as called: the chunks of 32
    # align with them, and the tail batch (rows 96-99) is padded with
    # copies of row 96, its chunk's first query
    at = np.concatenate([np.arange(100), np.full(4, 96)])
    scores = torch.cat([pm.candidate_scores(pstate, *(
        torch.from_numpy(x[at[i:i + 8]]) for x in (
            d["hr"][:, 0], d["hr"][:, 1], d["t_candidate"])))
        for i in range(0, len(at), 8)])[:100]
    s, ans = scores.numpy(), d["t_correct_index"]
    pos = s[np.arange(100), ans][:, None]
    # the protocol in numpy: the answer counts itself and every candidate
    # scoring as high; the top-10 a stable descending sort
    np.testing.assert_array_equal(got, (s >= pos).sum(1) + 1)
    np.testing.assert_array_equal(
        top, np.argsort(-s, axis=1, kind="stable")[:, :10])
    rows_a, rows_b = np.arange(0, 100, 4), np.arange(1, 100, 4)
    tie_a = s[rows_a, -1] == s[rows_a, ans[rows_a]]
    tie_b = s[rows_b, -1] == s[rows_b, 3]
    assert tie_a.sum() > len(rows_a) // 2 and tie_b.sum() > len(rows_b) // 2
    assert (got[rows_a[tie_a]] >= 3).all()
    for i in rows_b[tie_b]:
        tied = [int(p) for p in top[i] if p in (3, 19)]
        assert tied == sorted(tied)
    gap = np.abs(s - pos)
    gap[np.arange(100), ans] = np.inf
    near = (gap <= TIE_RTOL * (np.abs(s) + 4.0)).any(1)
    assert near[rows_a].all()
    assert ((got == want) | near).all()


def test_cpu_route_runs_eagerly_no_graph():
    """On the CPU every call runs its group function: nothing is memoized
    as a graph, and the eval log has no graph line."""
    _, _, _, pcfg, pm, pstate = _pair("TransE_l2")
    logs = []
    evaluate(pcfg, PDS, pm, pstate, "test", log=logs.append)
    calls = pm.eval_calls
    assert not calls.on_graphs(pstate)
    assert (calls.captured, calls.replays, calls.entries) == (0, 0, {})
    assert sum(calls.keys.values()) > 0
    assert not any("CUDA graphs" in x for x in logs)
    assert any(x.startswith("[0]Test takes") for x in logs)


def test_graph_route_only_on_a_card_without_plan_on_card_tables():
    """Which eval calls a card would capture: on one card without a plan,
    on tables on the card and on host-resident tables (--mix_cpu_gpu,
    mapped for the card) alike; none on the CPU or under a plan
    (--dist) whose collectives run over gloo."""
    from types import SimpleNamespace
    from dglke_tpu_torch.models.eval_step import EvalCalls

    class Model:   # what EvalCalls reads of a KEModel
        def __init__(self, device, plan=None):
            self.device, self.plan = device, plan

    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    on_card, on_host = SimpleNamespace(), SimpleNamespace(is_host=True)
    model = Model(card)
    calls = EvalCalls(model)
    assert calls.on_graphs(on_card) and calls.on_graphs(on_host)
    gloo = SimpleNamespace(comm=SimpleNamespace(backend="gloo"))
    for model in (Model(cpu), Model(card, plan=gloo)):
        for state in (on_card, on_host):
            assert not EvalCalls(model).on_graphs(state)


def test_eval_calls_hold_no_cycle_through_the_model():
    """A model and its eval calls are freed by reference counting alone:
    left to the cyclic collector, their CUDA graphs could be destroyed in
    the middle of another graph's capture."""
    import gc
    import weakref
    _, _, _, pcfg, pm, pstate = _pair("TransE_l2")
    evaluate(pcfg, PDS, pm, pstate, "test", log=QUIET)
    calls = weakref.ref(pm.eval_calls)
    gc.disable()
    try:
        del pm
        assert calls() is None
    finally:
        gc.enable()
