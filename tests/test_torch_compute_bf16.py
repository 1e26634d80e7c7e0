"""--compute_dtype bfloat16 in the port against the JAX package, on
identical numpy rows and id batches: the scores (their dtypes too), the
loss and the row gradients of KEModel._rows_loss_and_grads for all eight
families in both corruption directions; one training step a family (the
tables stay fp32); RESCAL on the stock route under the flag; eval ranks
untouched by it; the JAX package's bar from tests/test_train_e2e.py; and
the planted-structure gate under bf16 compute, family by family, wherever
the JAX package's bf16 run passes it at the same size.

Tolerances are stated in bf16 roundings, 2^-8 (one unit in the last
place of bf16's 8-bit significand), of the largest operand a quantity is
reduced from, not of the result: both packages round the same bf16
elementwise work, but XLA and PyTorch round some intermediates apart
(``0.5 / ans`` against ``g / (2 ans)`` in sqrt's derivative) and sum the
fp32 accumulations of bf16 reductions in other orders, so a result may
differ by roundings of its operands, which cancellation can make large
against the result itself.
  * scores: 4 roundings of S = max(gamma, max |fp32 score|), the scale at
    which the gamma-shifted reductions and a bf16 score round;
  * loss: 2 roundings of the fp32 loss;
  * row gradients: 8 roundings of the largest fp32 gradient entry of the
    same table (a row's gradient sums its scores' contributions, each at
    most that large).  RotatE: 32 roundings elementwise and 8 in the
    Frobenius norm, since the gradient of a modulus |z| is z / |z|, whose
    error grows as |z| nears the rounding error of z;
  * a training step: the update of every touched row within 8 roundings
    of the largest fp32 update (RotatE 32), the Adagrad state's increment
    within 16 roundings of the largest (it squares the gradient).
The fp32 reference is the port's own fp32 path on the bf16-rounded rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.data.dataset import planted_dataset as jax_planted
from dglke_tpu.data.dataset import synthetic_dataset as jax_synthetic
from dglke_tpu.models.ke_model import KEModel as JaxModel
from dglke_tpu.models.ke_model import TrainState as JaxState
from dglke_tpu.ops.embedding import EmbeddingState as JaxTable
from dglke_tpu.trainer import evaluate as jax_evaluate
from dglke_tpu.trainer import train as jax_train
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import planted_dataset, synthetic_dataset
from dglke_tpu_torch.models import ke_model as pke
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.trainer import evaluate, train
from dglke_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

ULP = 2.0 ** -8
N_ENT, N_REL, DIM, BATCH, NEG = 60, 5, 16, 8, 4      # 2 chunks of 4
C = BATCH // NEG
FAMILIES = {"TransE_l2": {}, "TransE_l1": {}, "TransR": {}, "DistMult": {},
            "ComplEx": {}, "RESCAL": {}, "RotatE": dict(double_ent=True),
            "SimplE": {}}
NAMES = list(FAMILIES)
TRANSLATIONAL = ("TransE_l2", "TransE_l1", "TransR", "RotatE")
GAMMA = 4.0


def _kw(model_name, compute_dtype="bfloat16", **extra):
    return dict(model_name=model_name, hidden_dim=DIM, gamma=GAMMA, lr=0.25,
                batch_size=BATCH, neg_sample_size=NEG,
                neg_adversarial_sampling=True, regularization_coef=1e-3,
                regularization_norm=3, batch_size_eval=8,
                compute_dtype=compute_dtype, **FAMILIES[model_name], **extra)


def _models(model_name, compute_dtype="bfloat16", **extra):
    kw = _kw(model_name, compute_dtype, **extra)
    return (JaxModel(JaxConfig(**kw), N_ENT, N_REL),
            KEModel(KGEConfig(**kw), N_ENT, N_REL, device="cpu"))


def _rows(jm, seed):
    """Gathered rows as the step has them: [h | t | neg] entity rows, the
    relation rows, TransR's projection rows (else None)."""
    rng = np.random.default_rng(seed)

    def draw(n, d):
        return (rng.standard_normal((n, d)) * 0.3).astype(np.float32)

    ent = draw(2 * BATCH + C * NEG, jm.entity_dim)
    rel = draw(BATCH, jm.relation_dim)
    proj = draw(BATCH, jm.proj_dim) if jm.is_transr else None
    return ent, rel, proj


def _t(x, dtype=None):
    if x is None:
        return None
    t = torch.from_numpy(x)
    return t if dtype is None else t.to(dtype)


def _grad_tol(name):
    return 32 if name == "RotatE" else 8


# ---------------------------------------------------------------------------
# Scores, loss and row gradients


@pytest.mark.parametrize("neg_deg_sample", [False, True],
                         ids=["uniform", "deg"])
@pytest.mark.parametrize("neg_head", [True, False], ids=["head", "tail"])
@pytest.mark.parametrize("model_name", NAMES)
def test_bf16_scores_match_jax(model_name, neg_head, neg_deg_sample):
    """_pos_neg_scores on bf16 rows: each score in the dtype the JAX
    package gives it (bf16 where it reduces in bf16, fp32 where a product
    comes out in fp32), values within 4 roundings of S."""
    jm, pm = _models(model_name)
    ent, rel, proj = _rows(jm, seed=2)
    sk = dict(neg_head=neg_head, num_chunks=C, chunk_size=NEG,
              neg_sample_size=NEG, neg_deg_sample=neg_deg_sample)

    def split(e, r, p):
        return (e[:BATCH], e[BATCH:2 * BATCH]), r, e[2 * BATCH:], p

    jb = [None if x is None else jnp.asarray(x).astype(jnp.bfloat16)
          for x in (ent, rel, proj)]
    jpos, jneg, _ = jm._pos_neg_scores(*split(*jb), **sk)
    pb = [_t(x, torch.bfloat16) for x in (ent, rel, proj)]
    ppos, pneg, _ = pm._pos_neg_scores(*split(*pb), **sk)
    ref = [None if x is None else x.float() for x in pb]
    rpos, rneg, _ = pm._pos_neg_scores(*split(*ref), **sk)
    for got, want, exact in ((ppos, jpos, rpos), (pneg, jneg, rneg)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype), (
            got.dtype, want.dtype)
        s = max(float(exact.abs().max()),
                GAMMA if model_name in TRANSLATIONAL else 0.0)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=0, atol=4 * ULP * s)


@pytest.mark.parametrize("neg_head", [True, False], ids=["head", "tail"])
@pytest.mark.parametrize("model_name", NAMES)
def test_bf16_loss_and_row_grads_match_jax(model_name, neg_head):
    jm, pm = _models(model_name)
    ent, rel, proj = _rows(jm, seed=0)
    ck = dict(b=BATCH, num_chunks=C, chunk_size=NEG, neg_sample_size=NEG,
              neg_head=neg_head)
    jloss, jlog, jgrads = jm._rows_loss_and_grads(
        *(None if x is None else jnp.asarray(x) for x in (ent, rel, proj)),
        None, **ck)
    ploss, plog, pgrads = pm._rows_loss_and_grads(
        _t(ent), _t(rel), _t(proj), None, **ck)
    _, pm32 = _models(model_name, "float32")
    rloss, _, rgrads = pm32._rows_loss_and_grads(
        *(None if x is None else _t(x, torch.bfloat16).float()
          for x in (ent, rel, proj)), None, **ck)
    assert set(plog) == set(jlog)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=2 * ULP)
    k = _grad_tol(model_name)
    for got, want, exact in zip(pgrads, jgrads, rgrads):
        if want is None:
            assert got is None
            continue
        assert got.dtype == torch.float32           # w.r.t. the fp32 rows
        got, want = got.numpy(), np.asarray(want)
        scale = float(exact.abs().max())
        np.testing.assert_allclose(got, want, rtol=0, atol=k * ULP * scale)
        if model_name == "RotatE":
            assert np.linalg.norm(got - want) <= 8 * ULP * float(
                torch.linalg.norm(exact))


# ---------------------------------------------------------------------------
# One training step


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


@pytest.mark.parametrize("neg_head", [True, False], ids=["head", "tail"])
@pytest.mark.parametrize("model_name", NAMES)
def test_bf16_train_step_matches_jax(model_name, neg_head, monkeypatch):
    monkeypatch.delenv("DGLKE_TPU_RESCAL_FUSED", raising=False)
    jm, pm = _models(model_name)
    _, pm32 = _models(model_name, "float32")
    jstate = _jax_state(jm)
    before = jax.device_get(jstate)
    pstate = state_from_numpy(before, device="cpu")
    rstate = state_from_numpy(before, device="cpu")
    h, r, t, neg = _batch()
    ids = [torch.from_numpy(x) for x in (h, r, t, neg)]
    jnew, jlog = jm.train_step(jstate, h, r, t, neg, None, neg_head=neg_head)
    pm.train_step(pstate, *ids, None, neg_head=neg_head)
    pm32.train_step(rstate, *ids, None, neg_head=neg_head)
    got, want, ref = (state_to_numpy(pstate), jax.device_get(jnew),
                      state_to_numpy(rstate))
    k = _grad_tol(model_name)
    for name in ("entity", "relation", "projection"):
        g, w, x, b = (getattr(s, name) for s in (got, want, ref, before))
        if w is None:
            assert g is None
            continue
        assert g.emb.dtype == g.state_sum.dtype == np.float32
        d_ref = np.abs(x.emb - b.emb).max()
        np.testing.assert_allclose(g.emb - b.emb, w.emb - b.emb, rtol=0,
                                   atol=k * ULP * d_ref)
        s_ref = np.abs(x.state_sum - b.state_sum).max()
        np.testing.assert_allclose(g.state_sum - b.state_sum,
                                   w.state_sum - b.state_sum, rtol=0,
                                   atol=16 * ULP * s_ref)
    assert pstate.entity.emb.dtype == torch.float32
    assert int(got.step) == int(want.step) == 4


def test_rescal_takes_the_stock_route_under_bf16(monkeypatch):
    """The JAX package gates its fused RESCAL route on compute_dtype
    (ke_model.py:253-256): under bf16 compute the relation gradient is the
    [B, Dr*De] rows and K2 applies it; the outer-product update (K3) never
    runs."""
    _, pm = _models("RESCAL")
    state = pm.init_state()
    assert not pm._rescal_factored(state)
    fp32 = KEModel(KGEConfig(**_kw("RESCAL", "float32")), N_ENT, N_REL,
                   device="cpu")
    assert fp32._rescal_factored(fp32.init_state())
    ids = [torch.from_numpy(x) for x in _batch()]
    _, _, grads = pm.loss_and_grads(state, *ids, None, neg_head=True)
    assert not isinstance(grads[2], tuple)
    assert grads[2].shape == (BATCH, DIM * DIM)

    def k3(*a, **k):
        raise AssertionError("the outer-product update ran")

    monkeypatch.setattr(pke, "outer_adagrad_update", k3)
    pm.train_step(state, *ids, None, neg_head=False)


# ---------------------------------------------------------------------------
# Eval, and training to quality


def _eval_data():
    rng = np.random.default_rng(5)

    def triples(n):
        return (rng.integers(0, N_ENT, n), rng.integers(0, N_REL, n),
                rng.integers(0, N_ENT, n))

    from dglke_tpu_torch.data.dataset import KGDataset
    return KGDataset(name="fam", n_entities=N_ENT, n_relations=N_REL,
                     train=triples(300), test=triples(29))


@pytest.mark.parametrize("model_name", NAMES)
def test_eval_is_untouched_by_bf16_compute(model_name):
    """The JAX package reads compute_dtype only in the training loss: the
    filtered ranks of one state are the same with and without the flag."""
    ds = _eval_data()
    jm, _ = _models(model_name)
    state = state_from_numpy(jax.device_get(_jax_state(jm, seed=3)),
                             device="cpu")
    quiet = lambda *a: None  # noqa: E731
    metrics = []
    for dtype in ("bfloat16", "float32"):
        cfg = KGEConfig(**_kw(model_name, dtype))
        model = KEModel(cfg, N_ENT, N_REL, device="cpu")
        metrics.append(evaluate(cfg, ds, model, state, "test", log=quiet))
    assert metrics[0] == metrics[1]


def test_bfloat16_compute_learns():
    """tests/test_train_e2e.py:155-161 in the port: the tables stay fp32
    and the filtered MRR clears 0.15."""
    ds = synthetic_dataset(n_entities=200, n_relations=5, n_train=4000,
                           n_valid=100, n_test=100, seed=3)
    cfg = KGEConfig(model_name="TransE_l2", hidden_dim=32, gamma=6.0,
                    lr=0.25, batch_size=256, neg_sample_size=64,
                    max_step=300, batch_size_eval=16, log_interval=100,
                    neg_adversarial_sampling=True, regularization_coef=1e-9,
                    seed=7, dataset="synthetic", compute_dtype="bfloat16")
    quiet = lambda *a: None  # noqa: E731
    model, state, _ = train(cfg, ds, log=quiet, device="cpu")
    assert state.entity.emb.dtype == state.relation.emb.dtype == \
        torch.float32
    assert state.entity.state_sum.dtype == torch.float32
    metrics = evaluate(cfg, ds, model, state, "test", log=quiet)
    assert metrics["MRR"] > 0.15, metrics


# tests/test_planted_quality.py:27-46, under bf16 compute
PLANTED_BASE = dict(hidden_dim=32, gamma=6.0, lr=0.25, batch_size=128,
                    neg_sample_size=32, max_step=1500, batch_size_eval=16,
                    log_interval=10**9, neg_adversarial_sampling=True,
                    regularization_coef=1e-9, seed=7, dataset="synthetic",
                    compute_dtype="bfloat16")
PLANTED = [
    ("TransE_l2", "line", dict(gamma=4.0, max_step=2000)),
    ("TransE_l1", "line", dict(gamma=8.0)),
    ("TransR", "line", dict(hidden_dim=16, lr=0.15)),
    ("RotatE", "line", dict(double_ent=True, lr=0.1)),
    ("DistMult", "cliques", dict(neg_adversarial_sampling=False,
                                 regularization_coef=2e-6, lr=0.15)),
    ("ComplEx", "cycle", dict(neg_adversarial_sampling=False,
                              regularization_coef=2e-6, lr=0.15)),
    ("SimplE", "cycle", dict(neg_adversarial_sampling=False,
                             regularization_coef=2e-6, lr=0.15)),
    ("RESCAL", "cycle", dict(hidden_dim=16, lr=0.1,
                             neg_adversarial_sampling=False)),
]


def _gate(m):
    return m["MRR"] >= 0.85 and m["HITS@10"] >= 0.99


@pytest.mark.parametrize("model_name,structure,overrides", PLANTED,
                         ids=[c[0] for c in PLANTED])
def test_planted_gate_under_bf16_compute(model_name, structure,
                                         overrides):
    """The gate (MRR >= 0.85, HITS@10 >= 0.99) under bf16 compute: the port
    must pass it wherever the JAX package's bf16 run passes it on the same
    planted graph and config."""
    n_clusters = 8 if structure == "cycle" else 10
    kw = {**PLANTED_BASE, "model_name": model_name, **overrides}
    quiet = lambda *a: None  # noqa: E731
    jds = jax_planted(structure, n_clusters=n_clusters)
    jcfg = JaxConfig(**kw)
    jmodel, jstate, _ = jax_train(jcfg, jds, log=quiet)
    jm = jax_evaluate(jcfg, jds, jmodel, jstate, "test", log=quiet)
    ds = planted_dataset(structure, n_clusters=n_clusters)
    cfg = KGEConfig(**kw)
    model, state, _ = train(cfg, ds, log=quiet, device="cpu")
    m = evaluate(cfg, ds, model, state, "test", log=quiet)
    print(f"planted {model_name} bf16: port {m}, JAX {jm}")
    if _gate(jm):
        assert _gate(m), (model_name, m, jm)
