"""dglke_tpu_torch's host-resident tables (--mix_cpu_gpu, host_table.py)
against the JAX package's (dglke_tpu/host_table.py) on the CPU, the
counterparts of tests/test_host_table.py.  Both packages get the same
numpy inputs; the port's host tables start from the JAX package's bit for
bit (the same numpy draws), so whole runs are compared.

Tolerances: one Adagrad update with duplicate ids within rtol 1e-6 / atol
1e-7 (the port sums each occurrence in another order than np.add.at);
20 training steps within rtol 1e-5 / atol 1e-6 on every table and 1e-5 on
every logged loss (fp32 scores and gradients differ in rounding between
XLA and PyTorch, and Adagrad carries the differences); ranks identical
(the same tie-exact count on the same tables).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (on the CPU: tests/conftest.py)

import dglke_tpu.host_table as jht
from dglke_tpu import trainer as jtrainer
from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.data.dataset import synthetic_dataset as jax_synthetic
from dglke_tpu.models import ke_model as jke
from dglke_tpu.utils import io as jax_io
import dglke_tpu_torch.host_table as pht
from dglke_tpu_torch import trainer as ptrainer
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import synthetic_dataset
from dglke_tpu_torch.data.sampler import EvalSampler, FilterIndex
from dglke_tpu_torch.models.ke_model import KEModel, TrainState
from dglke_tpu_torch.ops import rows as prows
from dglke_tpu_torch.ops.embedding import (EmbeddingState,
                                           sparse_adagrad_update)
from dglke_tpu_torch.utils import io as pt_io

torch.set_num_threads(2)

QUIET = lambda *a: None  # noqa: E731


def host_config(**kw):
    base = dict(
        model_name="TransE_l2", hidden_dim=32, gamma=6.0, lr=0.25,
        batch_size=256, neg_sample_size=64, max_step=300,
        batch_size_eval=16, log_interval=100, neg_adversarial_sampling=True,
        regularization_coef=1e-9, seed=7, dataset="synthetic",
        mix_cpu_gpu=True,
    )
    base.update(kw)
    return KGEConfig(**base), JaxConfig(**base)


@pytest.fixture(scope="module")
def tiny_ds():
    kw = dict(n_entities=200, n_relations=5, n_train=4000, n_valid=100,
              n_test=100, seed=3)
    pds, jds = synthetic_dataset(**kw), jax_synthetic(**kw)
    for split in ("train", "valid", "test"):
        for a, b in zip(getattr(pds, split), getattr(jds, split)):
            np.testing.assert_array_equal(a, b)
    return pds, jds


@pytest.fixture(scope="module")
def trained(tiny_ds):
    """80 host-mode steps of the port (TransE_l2), on the CPU."""
    cfg, _ = host_config(max_step=80)
    model, state, _ = ptrainer.train(cfg, tiny_ds[0], log=QUIET,
                                     device="cpu")
    return cfg, model, state


def _ranks_of(monkeypatch, module, name):
    """Capture the rank arrays handed to ``module.name`` (the metrics
    function an eval ends in)."""
    seen = []
    real = getattr(module, name)

    def keep(ranks, *a, **k):
        seen.append(np.asarray(ranks, np.int64).copy())
        return real(ranks, *a, **k)

    monkeypatch.setattr(module, name, keep)
    return seen


def _device_state(state) -> TrainState:
    """A TrainState holding copies of a HostState's tables."""
    def table(t):
        return None if t is None else EmbeddingState(t.emb.clone(),
                                                     t.state_sum.clone())
    return TrainState(table(state.entity), table(state.relation),
                      step=state.step, projection=table(state.projection))


def _jax_host_state(state) -> "jht.HostState":
    def table(t):
        return None if t is None else jht.HostEmbedding(
            t.emb.numpy().copy(), t.state_sum.numpy().copy())
    return jht.HostState(table(state.entity), table(state.relation),
                         table(state.projection), state.step)


def test_host_adagrad_matches_jax_with_duplicate_ids():
    """The port's host-table update (sparse_adagrad_update on a
    HostEmbedding, K2's plain version on the CPU) reproduces the JAX
    package's host_adagrad_update (np.add.at, the same ordering),
    duplicates included."""
    rng = np.random.default_rng(0)
    n, d, batch = 50, 16, 120
    emb = rng.normal(size=(n, d)).astype(np.float32)
    ss = rng.uniform(0.1, 2.0, (n,)).astype(np.float32)
    ids = rng.integers(0, n, (batch,)).astype(np.int32)   # many duplicates
    grads = rng.normal(size=(batch, d)).astype(np.float32)

    want = jht.HostEmbedding(emb.copy(), ss.copy())
    jht.host_adagrad_update(want, ids, grads, lr=0.3)
    got = pht.HostEmbedding(torch.from_numpy(emb.copy()),
                            torch.from_numpy(ss.copy()))
    sparse_adagrad_update(got, torch.from_numpy(ids),
                          torch.from_numpy(grads), 0.3)
    np.testing.assert_allclose(got.state_sum.numpy(), want.state_sum,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.emb.numpy(), want.emb, rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("n, d, batch", [(50, 16, 120), (1000, 400, 3000)])
def test_mapped_route_plain_matches_jax_host_adagrad_update(n, d, batch):
    """K2's mapped route written plainly (ops/rows.py:
    segment_update_mapped_plain: the distinct rows gathered into scratch,
    updated by segment, written back) against the JAX package's
    host_adagrad_update on the same numpy tables and duplicate ids, within
    rtol 1e-5 / atol 1e-6 (np.add.at sums each occurrence in another order
    than the segment sums)."""
    rng = np.random.default_rng(n)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    ss = rng.uniform(0.1, 2.0, (n,)).astype(np.float32)
    ids = rng.integers(0, n, (batch,)).astype(np.int32)
    grads = rng.normal(size=(batch, d)).astype(np.float32)
    want = jht.HostEmbedding(emb.copy(), ss.copy())
    jht.host_adagrad_update(want, ids, grads, lr=0.25)
    got_emb, got_ss = torch.from_numpy(emb.copy()), torch.from_numpy(ss.copy())
    prows.segment_update_mapped_plain(got_emb, got_ss, torch.from_numpy(ids),
                                      torch.from_numpy(grads), 0.25)
    np.testing.assert_allclose(got_ss.numpy(), want.state_sum, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_emb.numpy(), want.emb, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["TransE_l2", "TransR"])
def test_host_tables_lie_in_aligned_host_memory(name):
    """init_host_state places every table and state_sum in host_zeros
    memory (2 MB-aligned, advised for huge pages), and its log line says
    what pages they got."""
    cfg, _ = host_config(model_name=name, hidden_dim=12)
    model = KEModel(cfg, 300, 7, device="cpu")
    lines = []
    state = pht.init_host_state(model, seed=11, log=lines.append)
    for k in ("entity", "relation", "projection"):
        t = getattr(state, k)
        if t is None:
            continue
        for x in (t.emb, t.state_sum):
            assert x.data_ptr() % prows.HUGE_PAGE_BYTES == 0
            assert x.is_contiguous()
    assert "wrapped on the CPU" in lines[0] and "in 2 MB pages" in lines[0]


@pytest.mark.parametrize("name", ["TransE_l2", "TransR"])
def test_init_host_state_is_the_jax_packages_bit_for_bit(name):
    cfg, jcfg = host_config(model_name=name, hidden_dim=12)
    model = KEModel(cfg, 300, 7, device="cpu")
    got = pht.init_host_state(model, seed=11)
    want = jht.init_host_state(jke.KEModel(jcfg, 300, 7), seed=11)
    for k in ("entity", "relation", "projection"):
        g, w = getattr(got, k), getattr(want, k)
        if w is None:
            assert g is None
            continue
        assert g.emb.dtype == torch.float32
        np.testing.assert_array_equal(g.emb.numpy(), w.emb)
        np.testing.assert_array_equal(g.state_sum.numpy(), w.state_sum)
    assert got.step == 0 and got.is_host


def _losses(lines):
    return [float(m.group(1)) for ln in lines
            for m in [re.search(r"average loss: (\S+)", ln)] if m]


@pytest.mark.parametrize("name", ["TransE_l2", "RESCAL"])
def test_train_host_matches_jax_over_20_steps(tiny_ds, name):
    """The same seed gives the same tables and the same TrainSampler
    batches in both packages; 20 steps of train_host later every table
    agrees, and so does every logged loss."""
    cfg, jcfg = host_config(model_name=name, hidden_dim=16, max_step=20,
                            log_interval=10, lr=0.15)
    plog, jlog = [], []
    _, got, _ = ptrainer.train(cfg, tiny_ds[0], log=plog.append,
                               device="cpu")
    _, want, _ = jtrainer.train(jcfg, tiny_ds[1], log=jlog.append)
    assert isinstance(got, pht.HostState) and got.step == 20
    _assert_tables_close(got, want)
    pl, jl = _losses(plog), _losses(jlog)
    assert len(pl) == len(jl) == 2
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)


def _assert_tables_close(got, want, skip=None):
    """Every table and Adagrad state within rtol 1e-5 / atol 1e-6, but the
    rows ``skip`` lists for a table."""
    for k in ("entity", "relation", "projection"):
        g, w = getattr(got, k), getattr(want, k)
        if w is None:
            assert g is None
            continue
        keep = np.ones(len(w.emb), bool)
        keep[sorted((skip or {}).get(k, ()))] = False
        np.testing.assert_allclose(g.emb.numpy()[keep], w.emb[keep],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g.state_sum.numpy()[keep],
                                   w.state_sum[keep], rtol=1e-5, atol=1e-6)


# TransR scores by an L1 distance, whose gradient takes the sign of each
# component x = h_proj + r - t_proj (and of x against each negative).  A
# component within a rounding error of 0 may take opposite signs in the two
# packages, and Adagrad turns that into a step of a different size on the
# rows it touches.  Over this data's first 20 batches at batch 256 one such
# component flips, in step 11 (|x| = 1.5e-8, 0.07 of one fp32 rounding of
# its terms): from identical tables the two packages' entity rows 23 and 41,
# relation 2 and projection 2 differ by 2e-4, and a whole run carries that
# on (ROADMAP section C).  So the run is held step by step, each step from
# the same tables, and for TransR every row that no component within
# _NEAR_ZERO roundings of 0 touches is held at the stated tolerance: those
# components explain every row that differs.
_NEAR_ZERO = 4.0


def _transr_near_zero_rows(tables, batch, cfg, num_chunks, neg_size):
    """The entity ids and relation ids that an L1 component of TransR's
    step touches when that component lies within _NEAR_ZERO fp32 roundings
    of 0: |x| < _NEAR_ZERO * eps * (sum |h_k M_kj| + |r_j| + sum |t_k M_kj|),
    computed in float64 from the step's starting tables, for the positive
    triples and for every (query, negative) pair of a chunk."""
    ent, rel, proj = (t.emb.astype(np.float64) for t in tables)
    h, t, r, neg = batch["h"], batch["t"], batch["r"], batch["neg"]
    d = cfg.hidden_dim
    m = proj[r].reshape(-1, d, d)
    am = np.abs(m)

    def project(e):
        return (np.einsum("bd,bdr->br", ent[e], m),
                np.einsum("bd,bdr->br", np.abs(ent[e]), am))

    (hp, hs), (tp, ts), rr = project(h), project(t), rel[r]
    near = _NEAR_ZERO * np.finfo(np.float32).eps
    pos = (np.abs(hp + rr - tp) < near * (hs + np.abs(rr) + ts)).any(-1)
    ents, rels = set(h[pos]) | set(t[pos]), set(r[pos])
    bc = len(h) // num_chunks
    n = ent[neg].reshape(num_chunks, neg_size, d)
    mc = m.reshape(num_chunks, bc, d, d)
    np_ = np.einsum("ckd,cbdr->cbkr", n, mc)
    ns = np.einsum("ckd,cbdr->cbkr", np.abs(n), np.abs(mc))
    if batch["neg_head"]:       # negative heads against t_proj - r
        query, q, qs = t, tp - rr, ts + np.abs(rr)
    else:                       # negative tails against h_proj + r
        query, q, qs = h, hp + rr, hs + np.abs(rr)
    x = q.reshape(num_chunks, bc, 1, d) - np_
    scale = qs.reshape(num_chunks, bc, 1, d) + ns
    for c, b, k in np.argwhere((np.abs(x) < near * scale).any(-1)):
        ents |= {query[c * bc + b], neg[c * neg_size + k]}
        rels.add(r[c * bc + b])
    return ents, rels


@pytest.mark.parametrize("name", ["TransE_l2", "TransR", "RESCAL"])
def test_host_steps_match_jax_step_by_step(tiny_ds, name):
    """20 consecutive TrainSampler batches at batch 256; before each, the
    port's host tables are set to the JAX package's, then each package
    takes its host step (the port's host_step; the JAX package's row step
    and numpy Adagrad, its train_host's loop body); every table and loss
    agree, for TransR on every row but those of a component within a few
    roundings of 0, which are few."""
    from dglke_tpu.data.sampler import TrainSampler as JaxTrainSampler
    cfg, jcfg = host_config(model_name=name, hidden_dim=16, lr=0.15)
    model = KEModel(cfg, 200, 5, device="cpu")
    jm = jke.KEModel(jcfg, 200, 5)
    want = jht.init_host_state(jm, cfg.seed)
    sampler = JaxTrainSampler(tiny_ds[1], cfg.batch_size,
                              cfg.neg_sample_size, seed=cfg.seed)
    step_fn = jm.make_host_rows_step(
        cfg.batch_size, sampler.num_chunks * sampler.neg_sample_size)
    for _ in range(20):
        batch = next(sampler)
        tables = (want.entity, want.relation, want.projection)
        ents, rels = (_transr_near_zero_rows(
            tables, batch, cfg, sampler.num_chunks, sampler.neg_sample_size)
            if model.is_transr else (set(), set()))
        assert len(ents) <= 4 and len(rels) <= 2, (ents, rels)
        got = pht.HostState(*(None if t is None else pht.HostEmbedding(
            torch.from_numpy(t.emb.copy()),
            torch.from_numpy(t.state_sum.copy())) for t in tables))
        plog = pht.host_step(model, got, batch)
        ent_ids = np.concatenate([batch["h"], batch["t"], batch["neg"]])
        r = batch["r"]
        jlog, (g_ent, g_rel, g_proj) = step_fn(
            want.entity.emb[ent_ids], want.relation.emb[r],
            want.projection.emb[r] if model.is_transr else None,
            batch["impts"], batch["neg_head"])
        jht.host_adagrad_update(want.entity, ent_ids, np.asarray(g_ent),
                                cfg.lr)
        jht.host_adagrad_update(want.relation, r, np.asarray(g_rel), cfg.lr)
        if model.is_transr:
            jht.host_adagrad_update(want.projection, r, np.asarray(g_proj),
                                    cfg.lr)
        _assert_tables_close(got, want, skip={
            "entity": ents, "relation": rels, "projection": rels})
        np.testing.assert_allclose(float(plog["loss"]),
                                   float(jlog["loss"]), rtol=1e-5,
                                   atol=1e-5)


def test_host_mode_learns_and_checkpoint_interchanges(tiny_ds, tmp_path):
    """Host mode learns; its npy checkpoint evaluates on device tables to
    the same metrics, resumes into host tables exactly, and the JAX
    package's load_host_state reads it."""
    cfg, jcfg = host_config()
    model, state, _ = ptrainer.train(cfg, tiny_ds[0], log=QUIET,
                                     device="cpu")
    assert state.is_host and state.step == cfg.max_step
    m_host = ptrainer.evaluate(cfg, tiny_ds[0], model, state, "test",
                               log=QUIET)
    assert m_host["MRR"] > 0.20, m_host

    path = pt_io.save_model(cfg, model, state,
                            save_path=str(tmp_path / "ck"))
    assert pt_io.load_config(path).mix_cpu_gpu
    dev_state = pt_io.load_model_state(cfg, model, path)
    m_dev = ptrainer.evaluate(cfg, tiny_ds[0], model, dev_state, "test",
                              log=QUIET)
    assert m_dev == m_host

    resumed = pht.load_host_state(cfg, model, path)
    assert resumed.step == cfg.max_step
    assert torch.equal(resumed.entity.emb, state.entity.emb)
    assert torch.equal(resumed.entity.state_sum, state.entity.state_sum)

    jm = jke.KEModel(jcfg, 200, 5)
    jstate = jht.load_host_state(jcfg, jm, path)
    assert jstate.step == cfg.max_step
    np.testing.assert_array_equal(jstate.entity.emb,
                                  state.entity.emb.numpy())
    np.testing.assert_array_equal(jstate.relation.state_sum,
                                  state.relation.state_sum.numpy())


@pytest.mark.parametrize("name", ["TransE_l2", "TransR"])
def test_load_host_state_reads_a_jax_host_checkpoint(tiny_ds, tmp_path,
                                                     name):
    _, jcfg = host_config(model_name=name, hidden_dim=8, max_step=10)
    jm, jstate, _ = jtrainer.train(jcfg, tiny_ds[1], log=QUIET)
    path = jax_io.save_model(jcfg, jm, jstate, save_path=str(tmp_path))
    cfg = pt_io.load_config(path)
    assert cfg.mix_cpu_gpu
    model = KEModel(cfg, 200, 5, device="cpu")
    got = pht.load_host_state(cfg, model, path)
    assert got.step == 10
    for k in ("entity", "relation", "projection"):
        g, w = getattr(got, k), getattr(jstate, k)
        if w is None:
            assert g is None
            continue
        np.testing.assert_array_equal(g.emb.numpy(), w.emb)
        np.testing.assert_array_equal(g.state_sum.numpy(), w.state_sum)


def test_host_eval_ranks_match_jax_and_the_device_path(tiny_ds, trained,
                                                       monkeypatch):
    """Block-streamed host eval: the same filtered ranks as the JAX
    package's evaluate_host on the same tables, and as the port's device
    path (eval_ranks) on copies of them."""
    cfg, model, state = trained
    _, jcfg = host_config(max_step=80)
    pranks = _ranks_of(monkeypatch, ptrainer, "combine_rank_metrics")
    jranks = _ranks_of(monkeypatch, jke, "metrics_from_ranks")
    m_host = ptrainer.evaluate(cfg, tiny_ds[0], model, state, "test",
                               log=QUIET)
    m_dev = ptrainer.evaluate(cfg, tiny_ds[0], model, _device_state(state),
                              "test", log=QUIET)
    jht.evaluate_host(jcfg, tiny_ds[1], jke.KEModel(jcfg, 200, 5),
                      _jax_host_state(state), "test", log=QUIET)
    assert len(pranks) == 2 and len(jranks) == 1
    assert len(pranks[0]) == 200
    np.testing.assert_array_equal(pranks[0], jranks[0])
    np.testing.assert_array_equal(pranks[0], pranks[1])
    assert m_host == m_dev


def test_host_eval_query_chunking_keeps_every_rank(tiny_ds, trained,
                                                   monkeypatch):
    """Tiny query chunks (the split spans many padded chunks, 7 does not
    divide it) give the same ranks as one chunk."""
    cfg, model, state = trained
    ranks = _ranks_of(monkeypatch, ptrainer, "combine_rank_metrics")
    ptrainer.evaluate(cfg, tiny_ds[0], model, state, "test", log=QUIET)
    monkeypatch.setattr(pht, "_Q_CAP_BYTES", 1)
    monkeypatch.setattr(pht, "_Q_MIN_CHUNK", 7)
    ptrainer.evaluate(cfg, tiny_ds[0], model, state, "test", log=QUIET)
    np.testing.assert_array_equal(ranks[0], ranks[1])


def _self_ties(cfg, ds, state):
    """Per ranked row, in the eval's order: the sampled negatives whose
    table row equals the true entity's (kept ones only when filtered)."""
    ent = state.entity.emb.numpy()
    out = []
    for mode in ("head", "tail"):
        for ba in EvalSampler(ds, "test", cfg.batch_size_eval, mode,
                              FilterIndex(ds) if cfg.eval_filter else None,
                              seed=cfg.seed,
                              neg_sample_size=cfg.neg_sample_size_eval):
            true = ba["h"] if ba["neg_head"] else ba["t"]
            same = (ent[ba["neg"]][None] == ent[true][:, None]).all(-1)
            if "neg_keep" in ba:
                same &= ba["neg_keep"] > 0
            out.append(same.sum(1)[:ba["n_valid"]])
    return np.concatenate(out)


@pytest.mark.parametrize("filtered", [True, False], ids=["filtered", "raw"])
def test_host_sampled_eval_ranks_match_jax_and_the_device_path(
        tiny_ds, trained, monkeypatch, filtered):
    """--neg_sample_size_eval on host tables: the EvalSampler draws the
    same candidates in both packages; the ranks are the port's device
    path's exactly, and the JAX host path's but for the self-ties of raw
    ranking (a sampled negative that is the true entity scores the
    positive score up to rounding: one rank of difference at most per such
    copy, ROADMAP section C)."""
    cfg, model, state = trained
    kw = dict(neg_sample_size_eval=50, no_eval_filter=not filtered)
    cfg = dataclasses.replace(cfg, **kw)
    _, jcfg = host_config(max_step=80, **kw)
    pranks = _ranks_of(monkeypatch, ptrainer, "combine_rank_metrics")
    jranks = _ranks_of(monkeypatch, jke, "metrics_from_ranks")
    ptrainer.evaluate(cfg, tiny_ds[0], model, state, "test", log=QUIET)
    ptrainer.evaluate(cfg, tiny_ds[0], model, _device_state(state), "test",
                      log=QUIET)
    jht.evaluate_host(jcfg, tiny_ds[1], jke.KEModel(jcfg, 200, 5),
                      _jax_host_state(state), "test", log=QUIET)
    assert len(pranks[0]) == 200
    np.testing.assert_array_equal(pranks[0], pranks[1])
    ties = _self_ties(cfg, tiny_ds[0], state)
    diff = np.abs(pranks[0] - jranks[0])
    assert np.all(diff <= ties) and np.all(diff[ties == 0] == 0)
    if filtered:
        np.testing.assert_array_equal(pranks[0], jranks[0])


def test_host_eval_refuses_candidate_lists(trained):
    """Candidate-list (wikikg90M) eval needs the table on the device: the
    host path refuses it, as the JAX package's does (the port has no
    ShardingPlan, the JAX test's other refusal)."""
    _, model, state = trained
    sampler = ptrainer.CandidateEvalSampler(
        {"h,r->t": {"hr": np.zeros((2, 2), np.int32),
                    "t_candidate": np.zeros((2, 3), np.int32),
                    "t_correct_index": np.zeros(2, np.int32)}}, 2)
    with pytest.raises(NotImplementedError, match="drop --mix_cpu_gpu"):
        pht.evaluate_host_with_samplers(model, state, [sampler], log=QUIET)


def test_host_mode_is_bit_reproducible(tiny_ds):
    """Host-mode training from a seed gives the same bits twice (the
    device path's guarantee, tests/test_train_e2e.py:147), and another
    seed other tables."""
    def run(seed):
        cfg, _ = host_config(max_step=30, log_interval=10, seed=seed)
        logs = []
        _, state, _ = ptrainer.train(cfg, tiny_ds[0], log=logs.append,
                                     device="cpu")
        return state, [x for x in logs if "average" in x]

    (s1, l1), (s2, l2), (s3, _) = run(3), run(3), run(4)
    for k in ("entity", "relation"):
        assert torch.equal(getattr(s1, k).emb, getattr(s2, k).emb)
        assert torch.equal(getattr(s1, k).state_sum,
                           getattr(s2, k).state_sum)
    assert l1 == l2 and len(l1) == 12
    assert not torch.equal(s1.entity.emb, s3.entity.emb)
