"""The six score families ported after TransE — TransR, DistMult, ComplEx,
RESCAL, RotatE and SimplE — against the JAX package, on identical numpy
tables and id batches: scores and their gradients, one training step in
each corruption direction, and filtered full-entity ranks.

Tolerances: rtol 1e-5 / atol 1e-5 on scores and score gradients, rtol
1e-5 / atol 1e-6 on a training step's tables, Adagrad state and loss
(fp32 on both sides, sums in another order); RESCAL's factored step
against JAX's stock and fused steps within rtol 1e-5 / atol 5e-6 (the
relation gradient is summed in another order and, in the fused JAX
kernel, subtracted per occurrence).  Filtered ranks are identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.data.dataset import KGDataset as JaxDataset
from dglke_tpu.data.sampler import EvalSampler as JaxSampler
from dglke_tpu.data.sampler import FilterIndex as JaxFilter
from dglke_tpu.models.ke_model import KEModel as JaxModel
from dglke_tpu.models.ke_model import TrainState as JaxState
from dglke_tpu.ops.embedding import EmbeddingState as JaxTable
from dglke_tpu.trainer import evaluate as jax_evaluate
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import KGDataset
from dglke_tpu_torch.data.sampler import EvalSampler, FilterIndex
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.trainer import evaluate
from dglke_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

N_ENT, N_REL, DIM, BATCH, NEG = 60, 5, 16, 8, 4      # 2 chunks of 4
C, BC = BATCH // NEG, NEG

# family -> its config overrides (RotatE's complex entities hold a real and
# an imaginary half of the relation's width)
FAMILIES = {"TransR": {}, "DistMult": {}, "ComplEx": {}, "RESCAL": {},
            "RotatE": dict(double_ent=True), "SimplE": {}}
NAMES = list(FAMILIES)


def _kw(model_name, **extra):
    return dict(model_name=model_name, hidden_dim=DIM, gamma=4.0, lr=0.25,
                batch_size=BATCH, neg_sample_size=NEG,
                neg_adversarial_sampling=True, regularization_coef=1e-3,
                regularization_norm=3, batch_size_eval=8,
                **FAMILIES[model_name], **extra)


def _models(model_name, **extra):
    kw = _kw(model_name, **extra)
    return (JaxModel(JaxConfig(**kw), N_ENT, N_REL),
            KEModel(KGEConfig(**kw), N_ENT, N_REL, device="cpu"))


def _jax_state(jm, seed=0):
    rng = np.random.default_rng(seed)

    def table(n, d):
        emb = (rng.standard_normal((n, d)) * 0.3).astype(np.float32)
        ss = np.abs(rng.standard_normal(n)).astype(np.float32)
        return JaxTable(jnp.asarray(emb), jnp.asarray(ss))

    ent, rel = table(N_ENT, jm.entity_dim), table(N_REL, jm.relation_dim)
    proj = table(N_REL, jm.proj_dim) if jm.is_transr else None
    return JaxState(ent, rel, proj, jnp.asarray(3, jnp.int32))


def _batch(seed=1):
    """h/t drawn from a few entities and r repeated, so [h | t | neg] and
    the relation ids hold duplicates."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 12, BATCH).astype(np.int32)
    t = rng.integers(0, 12, BATCH).astype(np.int32)
    r = rng.integers(0, N_REL, BATCH).astype(np.int32)
    r[1] = r[0]
    neg = rng.integers(0, N_ENT, C * NEG).astype(np.int32)
    neg[:2] = h[:2]
    return h, r, t, neg


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Scores


@pytest.mark.parametrize("neg_deg_sample", [False, True],
                         ids=["uniform", "deg"])
@pytest.mark.parametrize("neg_head", [True, False], ids=["head", "tail"])
@pytest.mark.parametrize("model_name", NAMES)
def test_scores_and_gradients_match_jax(model_name, neg_head,
                                        neg_deg_sample):
    """KEModel._pos_neg_scores (TransR's projections included): values and
    gradients w.r.t. every input row."""
    jm, pm = _models(model_name)
    js = jax.device_get(_jax_state(jm))
    rng = np.random.default_rng(2)
    h, t, n = (js.entity.emb[rng.integers(0, N_ENT, k)]
               for k in (BATCH, BATCH, C * NEG))
    r = js.relation.emb[rng.integers(0, N_REL, BATCH)]
    p = (js.projection.emb[rng.integers(0, N_REL, BATCH)]
         if jm.is_transr else np.zeros((BATCH, 1), np.float32))
    k = BC + NEG if neg_deg_sample else NEG
    w_pos = rng.uniform(0.5, 2.0, BATCH).astype(np.float32)
    w_neg = rng.uniform(0.5, 2.0, (BATCH, k)).astype(np.float32)
    sk = dict(neg_head=neg_head, num_chunks=C, chunk_size=BC,
              neg_sample_size=NEG, neg_deg_sample=neg_deg_sample)

    def jfn(h, t, r, n, p):
        pos, neg, _ = jm._pos_neg_scores(
            (h, t), r, n, p if jm.is_transr else None, **sk)
        return jnp.sum(pos * w_pos) + jnp.sum(neg * w_neg)

    want, want_g = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3, 4))(
        h, t, r, n, p)
    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in (h, t, r, n, p)]
    pos, neg, pk = pm._pos_neg_scores(
        (ts[0], ts[1]), ts[2], ts[3], ts[4] if pm.is_transr else None, **sk)
    assert pk == k and neg.shape == (BATCH, k)
    got = (torch.sum(pos * torch.from_numpy(w_pos))
           + torch.sum(neg * torch.from_numpy(w_neg)))
    got_g = torch.autograd.grad(got, ts, allow_unused=True)
    _close(got.detach(), want, atol=1e-5)
    for g, wg in zip(got_g, want_g):
        _close(np.zeros_like(wg) if g is None else g, wg, atol=1e-5)


# ---------------------------------------------------------------------------
# One training step


def _step_both(jm, pm, neg_head, seed=0):
    jstate = _jax_state(jm, seed)
    pstate = state_from_numpy(jax.device_get(jstate), device="cpu")
    h, r, t, neg = _batch()
    jnew, jlog = jm.train_step(jstate, h, r, t, neg, None, neg_head=neg_head)
    out, plog = pm.train_step(pstate, *(torch.from_numpy(x)
                                        for x in (h, r, t, neg)), None,
                              neg_head=neg_head)
    assert out is pstate        # in place
    return state_to_numpy(pstate), plog, jax.device_get(jnew), jlog


def _check_step(got, plog, want, jlog, rtol, atol):
    assert set(plog) == set(jlog)
    for k in jlog:
        _close(plog[k], jlog[k], rtol, atol)
    assert int(got.step) == int(want.step) == 4
    assert (got.projection is None) == (want.projection is None)
    for name in ("entity", "relation", "projection"):
        g, w = getattr(got, name), getattr(want, name)
        if w is not None:
            _close(g.emb, w.emb, rtol, atol)
            _close(g.state_sum, w.state_sum, rtol, atol)


@pytest.mark.parametrize("neg_head", [True, False], ids=["head", "tail"])
@pytest.mark.parametrize("model_name", NAMES)
def test_train_step_matches_jax(model_name, neg_head, monkeypatch):
    """RESCAL: the port's factored step against JAX's stock step."""
    monkeypatch.delenv("DGLKE_TPU_RESCAL_FUSED", raising=False)
    jm, pm = _models(model_name)
    atol = 5e-6 if model_name == "RESCAL" else 1e-6
    _check_step(*_step_both(jm, pm, neg_head), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("neg_head", [True, False], ids=["head", "tail"])
def test_rescal_step_matches_jax_fused(neg_head, monkeypatch):
    """Against the JAX package's fused route (its outer-product kernel in
    interpret mode), factors included."""
    monkeypatch.setenv("DGLKE_TPU_RESCAL_FUSED", "1")
    jm, pm = _models("RESCAL")
    jstate = _jax_state(jm)
    pstate = state_from_numpy(jax.device_get(jstate), device="cpu")
    h, r, t, neg = _batch()
    _, _, jg = jm.loss_and_grads(jstate, h, r, t, neg, None,
                                 neg_head=neg_head)
    _, _, pg = pm.loss_and_grads(pstate, *(torch.from_numpy(x)
                                           for x in (h, r, t, neg)), None,
                                 neg_head=neg_head)
    assert jg[2][0] == pg[2][0] == "outer"
    _close(pg[1], jg[1], atol=5e-6)
    for got, want in zip(pg[2][1:], jg[2][1:]):
        _close(got, want, atol=5e-6)
    _check_step(*_step_both(jm, pm, neg_head), rtol=1e-5, atol=5e-6)


@pytest.mark.parametrize("neg_head", [True, False], ids=["head", "tail"])
@pytest.mark.parametrize("model_name", ["RESCAL", "TransR"])
def test_neg_deg_sample_step_matches_jax(model_name, neg_head, monkeypatch):
    """The batch's own entities as extra negatives; RESCAL then takes the
    stock route in both packages."""
    monkeypatch.delenv("DGLKE_TPU_RESCAL_FUSED", raising=False)
    jm, pm = _models(model_name, neg_deg_sample=True)
    _check_step(*_step_both(jm, pm, neg_head), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("extra,factored", [
    ({}, True), (dict(neg_deg_sample=True), False),
    (dict(emb_dtype="bfloat16"), False)], ids=["fp32", "deg", "bf16"])
def test_rescal_route(extra, factored):
    """Factored relation gradients exactly where the JAX package's fused
    route applies: fp32 tables and no neg_deg_sample."""
    pm = KEModel(KGEConfig(**_kw("RESCAL", **extra)), N_ENT, N_REL,
                 device="cpu")
    state = pm.init_state()
    _, _, grads = pm.loss_and_grads(state, *(torch.from_numpy(x) for x in
                                             _batch()), None, neg_head=True)
    assert isinstance(grads[2], tuple) == factored
    if not factored:
        assert grads[2].shape == (BATCH, DIM * DIM)
    assert grads[3] is None


def test_transr_state_has_a_projection_table():
    _, pm = _models("TransR")
    state = pm.init_state()
    assert state.projection.emb.shape == (N_REL, DIM * DIM)
    assert float(state.projection.emb.abs().max()) <= 1.0
    assert not state.projection.state_sum.any()
    _, pm = _models("DistMult")
    assert pm.init_state().projection is None


# ---------------------------------------------------------------------------
# Filtered full-entity ranks


def _eval_data():
    rng = np.random.default_rng(5)

    def triples(n):
        return (rng.integers(0, N_ENT, n), rng.integers(0, N_REL, n),
                rng.integers(0, N_ENT, n))

    kw = dict(name="fam", n_entities=N_ENT, n_relations=N_REL,
              train=triples(300), test=triples(29))
    return JaxDataset(**kw), KGDataset(**kw)


JDS, PDS = _eval_data()


@pytest.mark.parametrize("block", [None, 16], ids=["one_block", "blocks16"])
@pytest.mark.parametrize("mode", ["head", "tail"])
@pytest.mark.parametrize("model_name", NAMES)
def test_eval_ranks_identical(model_name, mode, block):
    jm, pm = _models(model_name)
    jstate = _jax_state(jm, seed=3)
    pstate = state_from_numpy(jax.device_get(jstate), device="cpu")
    jsampler = JaxSampler(JDS, "test", 8, mode, JaxFilter(JDS))
    psampler = EvalSampler(PDS, "test", 8, mode, FilterIndex(PDS))
    n = 0
    for jb, pb in zip(jsampler, psampler):
        want = np.asarray(jm.eval_ranks(
            jstate, jb["h"], jb["r"], jb["t"], jb["filter_ids"],
            jb["filter_mask"], neg_head=jb["neg_head"], block=block))
        got = pm.eval_ranks(
            pstate, *(torch.from_numpy(pb[k]) for k in
                      ("h", "r", "t", "filter_ids", "filter_mask")),
            neg_head=pb["neg_head"], block=block)
        np.testing.assert_array_equal(got.numpy(), want)
        n += 1
    assert n == len(psampler) == 4


@pytest.mark.parametrize("model_name", NAMES)
def test_evaluate_metrics_identical(model_name):
    kw = _kw(model_name)
    jm, pm = _models(model_name)
    jstate = _jax_state(jm, seed=4)
    pstate = state_from_numpy(jax.device_get(jstate), device="cpu")
    quiet = lambda *a: None  # noqa: E731
    want = jax_evaluate(JaxConfig(**kw), JDS, jm, jstate, "test", log=quiet)
    got = evaluate(KGEConfig(**kw), PDS, pm, pstate, "test", log=quiet)
    assert got == want


@pytest.mark.parametrize("model_name", NAMES)
def test_eval_block_size_follows_jax(model_name):
    jm, pm = _models(model_name)
    for b in (8, 500):
        assert pm._eval_block_size(b) == jm._eval_block_size(b)
