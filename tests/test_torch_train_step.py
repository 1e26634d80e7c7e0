"""One dglke_tpu_torch training step against the JAX package's, on identical
numpy tables and id batches carried across with state_from_numpy.

Tolerances: rtol 1e-5 / atol 1e-6 on tables, Adagrad state, gradients
and loss (fp32 on both sides, sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.models.ke_model import KEModel as JaxModel
from dglke_tpu.models.ke_model import TrainState as JaxState
from dglke_tpu.ops.embedding import EmbeddingState as JaxTable
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.host_table import init_host_state
from dglke_tpu_torch.models import ke_model
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
N_REL, DIM, BATCH, NEG = 5, 16, 8, 4

CFG = dict(model_name="TransE_l2", hidden_dim=DIM, gamma=4.0, lr=0.25,
           batch_size=BATCH, neg_sample_size=NEG,
           neg_adversarial_sampling=True, regularization_coef=1e-3,
           regularization_norm=3)


def _jax_state(n_ent, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)

    def table(n):
        emb = (rng.standard_normal((n, DIM)) * 0.3).astype(np.float32)
        ss = np.abs(rng.standard_normal(n)).astype(np.float32)
        return JaxTable(jnp.asarray(emb, dtype), jnp.asarray(ss))

    return JaxState(table(n_ent), table(N_REL), None,
                    jnp.asarray(3, jnp.int32))


def _batch(n_ent, seed=1):
    """h/t drawn from a few entities so [h | t | neg] repeats ids."""
    rng = np.random.default_rng(seed)
    hot = min(n_ent, 12)
    h = rng.integers(0, hot, BATCH).astype(np.int32)
    t = rng.integers(0, hot, BATCH).astype(np.int32)
    r = rng.integers(0, N_REL, BATCH).astype(np.int32)
    neg = rng.integers(0, n_ent, (BATCH // NEG) * NEG).astype(np.int32)
    neg[:2] = h[:2]
    impts = rng.uniform(0.5, 2.0, BATCH).astype(np.float32)
    return h, r, t, neg, impts


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "impts"])
@pytest.mark.parametrize("n_ent", [60, 2500])
@pytest.mark.parametrize("neg_head", [True, False])
def test_train_step_matches_jax(neg_head, n_ent, weighted):
    """60 entities: the JAX update takes its dense one-hot arm for both
    tables; 2,500: its scatter arm for the entity table."""
    jstate = _jax_state(n_ent)
    pstate = state_from_numpy(jax.device_get(jstate), device="cpu")
    h, r, t, neg, impts = _batch(n_ent)
    impts = impts if weighted else None
    jm = JaxModel(JaxConfig(**CFG), n_ent, N_REL)
    pm = KEModel(KGEConfig(**CFG), n_ent, N_REL, device="cpu")

    jloss, jlog, jgrads = jm.loss_and_grads(
        jstate, h, r, t, neg, impts, neg_head=neg_head)
    tb = [torch.from_numpy(x) for x in (h, r, t, neg)]
    timp = None if impts is None else torch.from_numpy(impts)
    ploss, plog, pgrads = pm.loss_and_grads(pstate, *tb, timp,
                                            neg_head=neg_head)
    _close(ploss, jloss)
    np.testing.assert_array_equal(pgrads[0].numpy(), np.asarray(jgrads[0]))
    _close(pgrads[1], jgrads[1])
    _close(pgrads[2], jgrads[2])

    jnew, jlog = jm.train_step(jstate, h, r, t, neg, impts,
                               neg_head=neg_head)
    out, plog = pm.train_step(pstate, *tb, timp, neg_head=neg_head)
    assert out is pstate        # in place
    assert set(plog) == set(jlog)
    for k in jlog:
        _close(plog[k], jlog[k])
    got, want = state_to_numpy(pstate), jax.device_get(jnew)
    assert int(got.step) == int(want.step) == 4
    for name in ("entity", "relation"):
        g, w = getattr(got, name), getattr(want, name)
        _close(g.emb, w.emb)
        _close(g.state_sum, w.state_sum)


def test_train_step_refuses_a_batch_off_the_models_device_on_host_tables():
    """The step moves nothing between the host and the device: on host
    tables, whose kernels' plain versions would take ids on the CPU, a
    batch on another device than the model's is refused before any gather
    or update."""
    cfg = KGEConfig(**CFG, mix_cpu_gpu=True)
    model = KEModel(cfg, 60, N_REL, device="cpu")
    state = init_host_state(model, cfg.seed)
    before = state.entity.emb.clone()
    h, r, t, neg, _ = (torch.from_numpy(x) for x in _batch(60))
    model.device = torch.device("meta")   # ids built on the CPU
    with pytest.raises(ValueError, match="moves nothing"):
        model.train_step(state, h, r, t, neg, None, neg_head=True)
    assert state.step == 0 and torch.equal(state.entity.emb, before)


@pytest.mark.parametrize("host", [True, False],
                         ids=["host tables", "TrainState"])
def test_rescal_takes_the_row_route_on_host_tables_only(host, monkeypatch):
    """RESCAL on host tables takes the plain row route on every device, the
    CPU included, as the JAX package's host mode does: the outer-product
    update (K3) is never called and K2 writes the relation rows.  On a
    TrainState on the CPU the same step keeps the factored route."""
    cfg = KGEConfig(**dict(CFG, model_name="RESCAL"), mix_cpu_gpu=host)
    model = KEModel(cfg, 60, N_REL, device="cpu")
    state = init_host_state(model, cfg.seed) if host else model.init_state()
    calls = []
    monkeypatch.setattr(ke_model, "outer_adagrad_update",
                        lambda *a, **k: calls.append(a))
    before = state.relation.emb.clone()
    h, r, t, neg, _ = (torch.from_numpy(x) for x in _batch(60))
    model.train_step(state, h, r, t, neg, None, neg_head=False)
    assert model._rescal_factored(state) is not host
    assert len(calls) == (0 if host else 1)
    assert torch.equal(state.relation.emb, before) is not host


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["float32", "bfloat16"])
def test_state_round_trip(dtype):
    jstate = jax.device_get(_jax_state(40, seed=2, dtype=dtype))
    pstate = state_from_numpy(jstate, device="cpu")
    want_dtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    assert pstate.entity.emb.dtype == want_dtype
    assert pstate.entity.state_sum.dtype == torch.float32
    back = state_to_numpy(pstate)
    assert int(back.step) == 3
    for name in ("entity", "relation"):
        np.testing.assert_array_equal(
            getattr(back, name).emb,
            np.asarray(getattr(jstate, name).emb, np.float32))
        np.testing.assert_array_equal(getattr(back, name).state_sum,
                                      getattr(jstate, name).state_sum)
