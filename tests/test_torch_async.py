"""dglke_tpu_torch's --async_update, step groups and host-fed route against
the JAX package's.

The JAX package defers entity updates only inside a fused call of s steps
(make_train_superstep / the device pipeline's scan); the port runs groups
of s steps with the same deferral: a group of s async steps on the same
packed batches must give the JAX superstep's tables.  s itself must be the
JAX package's on every route, and the host-fed route (datasets smaller
than two batches) must draw the JAX TrainSampler's batches.

Tolerances: rtol 1e-5 / atol 1e-6 on tables and Adagrad state (fp32 on
both sides, sums in another order), as in tests/test_torch_train_step.py.
"""

import itertools

import numpy as np
import pytest
import torch

import jax

import dglke_tpu.trainer as jax_trainer
from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.data.dataset import synthetic_dataset as jax_synthetic
from dglke_tpu.data.sampler import TrainSampler as JaxTrainSampler
from dglke_tpu.models.ke_model import KEModel as JaxModel
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import synthetic_dataset
from dglke_tpu_torch.data.sampler import TrainSampler
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.models.fed_step import unpack_batch
from dglke_tpu_torch.trainer import HostFeed, steps_per_group, train
from dglke_tpu_torch.utils.convert import state_from_numpy

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
N_ENT, N_REL, DIM, B, NEG = 60, 4, 8, 16, 4
QUIET = lambda *a: None  # noqa: E731


def _cfg(**over):
    kw = dict(model_name="TransE_l2", hidden_dim=DIM, gamma=4.0, lr=0.25,
              batch_size=B, neg_sample_size=NEG,
              neg_adversarial_sampling=True, regularization_coef=1e-3)
    kw.update(over)
    return kw


def _packed(s, seed=0):
    """s packed [h | r | t | neg] batches, h and t from a few entities so
    that steps touch the same rows."""
    rng = np.random.RandomState(seed)
    h = rng.randint(0, 10, (s, B))
    t = rng.randint(0, 10, (s, B))
    r = rng.randint(0, N_REL, (s, B))
    neg = rng.randint(0, N_ENT, (s, (B // NEG) * NEG))
    return np.concatenate([h, r, t, neg], axis=1).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("model_name", ["TransE_l2", "RESCAL", "TransR"])
@pytest.mark.parametrize("async_update", [True, False],
                         ids=["async", "sync"])
def test_group_matches_jax_superstep(model_name, async_update):
    """A group of 4 steps against the JAX superstep (s = 4) on the same
    packed batches: tables and Adagrad state within fp32 tolerance."""
    s = 4
    kw = _cfg(model_name=model_name, async_update=async_update)
    jm = JaxModel(JaxConfig(**kw), N_ENT, N_REL)
    pm = KEModel(KGEConfig(**kw), N_ENT, N_REL, device="cpu")
    jstate = jm.init_state(jax.random.PRNGKey(0))
    pstate = state_from_numpy(jax.device_get(jstate), device="cpu")
    packed = _packed(s)
    step = jm.make_train_superstep(B, s, donate=False)
    jout, _ = step(jstate, packed, None)
    pending = None
    for i in range(s):
        h, r, t = (torch.from_numpy(packed[i, k * B:(k + 1) * B])
                   for k in range(3))
        neg = torch.from_numpy(packed[i, 3 * B:])
        if async_update:
            pstate, pending, _ = pm.train_step_async(
                pstate, pending, h, r, t, neg, None, neg_head=i % 2 == 0)
        else:
            pstate, _ = pm.train_step(pstate, h, r, t, neg, None,
                                      neg_head=i % 2 == 0)
    pm.flush_async(pstate, pending)
    jout = jax.device_get(jout)
    for table in ("entity", "relation") + (("projection",)
                                           if model_name == "TransR"
                                           else ()):
        _close(getattr(pstate, table).emb, getattr(jout, table).emb)
        _close(getattr(pstate, table).state_sum,
               getattr(jout, table).state_sum)
    assert pstate.step == int(jout.step) == s


def test_async_differs_from_sync_and_defers_the_entity_only():
    """After one async step only the relations moved; the deferred entity
    update lands with the flush."""
    kw = _cfg()
    pm = KEModel(KGEConfig(**kw), N_ENT, N_REL, device="cpu")
    state = pm.init_state()
    ent0, rel0 = state.entity.emb.clone(), state.relation.emb.clone()
    packed = torch.from_numpy(_packed(1)[0])
    args = (packed[:B], packed[B:2 * B], packed[2 * B:3 * B],
            packed[3 * B:], None)
    state, pending, _ = pm.train_step_async(state, None, *args,
                                            neg_head=True)
    assert torch.equal(state.entity.emb, ent0)
    assert not torch.equal(state.relation.emb, rel0)
    ids, grads = pending
    assert ids.shape == (3 * B,) and grads.shape == (3 * B, DIM)
    pm.flush_async(state, pending)
    assert not torch.equal(state.entity.emb, ent0)
    assert pm.flush_async(state, None) is state


# s over a grid, against the JAX package's own choice: its train() is run
# until it builds the feed for the chosen route, where the size is read.
class _Chosen(Exception):
    pass


def _jax_group_size(monkeypatch, jcfg, jds):
    seen = []

    def pipe(model, dataset, batch_size, neg_total, s, **kw):
        seen.append(s)
        raise _Chosen

    def superstep(self, batch_size, s, donate=True):
        seen.append(s)
        raise _Chosen

    def packed(self, batch_size, donate=True):
        seen.append(1)
        raise _Chosen

    monkeypatch.setattr(jax_trainer, "DevicePipeline", pipe)
    monkeypatch.setattr(JaxModel, "make_train_superstep", superstep)
    monkeypatch.setattr(JaxModel, "make_train_step_packed", packed)
    with pytest.raises(_Chosen):
        jax_trainer.train(jcfg, jds, log=QUIET)
    return seen[-1]


GRID = list(itertools.product(
    [(40, 10), (30, 10), (100, 25), (15, 5), (2000, 1000), (64, 7)],
    [(False, -1), (True, -1), (False, 20)],
    [12, 24, 200]))


@pytest.mark.parametrize("steps,interval,valid,save,n_train", [
    (m, li, v, sv, n) for (m, li), (v, sv), n in GRID])
def test_group_size_equals_jax(monkeypatch, steps, interval, valid, save,
                               n_train):
    kw = _cfg(max_step=steps, log_interval=interval, valid=valid,
              eval_interval=50, save_interval=save, batch_size=8,
              neg_sample_size=4)
    data = dict(n_entities=N_ENT, n_relations=N_REL, n_train=n_train,
                n_valid=10, n_test=10, seed=0)
    pcfg = KGEConfig(**kw)
    device_route = n_train >= 2 * pcfg.batch_size
    want = _jax_group_size(monkeypatch, JaxConfig(**kw),
                           jax_synthetic(**data))
    notes = []
    assert steps_per_group(pcfg, n_train, device_route,
                           log=notes.append) == want
    assert all("NOTE" in x for x in notes)


def _run(ds, **over):
    cfg = KGEConfig(**_cfg(**{"max_step": 24, "log_interval": 12,
                               "seed": 3, **over}))
    logs = []
    _, state, _ = train(cfg, ds, log=logs.append, device="cpu")
    return state, logs


DS = synthetic_dataset(N_ENT, N_REL, n_train=400, n_valid=10, n_test=10)


def test_async_runs_bit_identical_and_not_sync():
    a, logs = _run(DS, async_update=True)
    b, _ = _run(DS, async_update=True)
    c, _ = _run(DS)
    assert any("device-resident pipeline: 12 steps a group" in x
               for x in logs)
    assert a.step == 24
    for table in ("entity", "relation"):
        assert torch.equal(getattr(a, table).emb, getattr(b, table).emb)
        assert torch.equal(getattr(a, table).state_sum,
                           getattr(b, table).state_sum)
    assert not torch.equal(a.entity.emb, c.entity.emb)


def test_async_at_group_size_one_is_sync():
    a, logs = _run(DS, async_update=True, max_step=15, log_interval=5)
    b, _ = _run(DS, max_step=15, log_interval=5)
    assert any("--async_update has no effect" in x for x in logs)
    assert torch.equal(a.entity.emb, b.entity.emb)
    assert torch.equal(a.relation.emb, b.relation.emb)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n_train", [5, 16, 40])
def test_train_sampler_batches_identical(seed, n_train):
    """The port's TrainSampler draws the JAX package's batches: the same
    permutations, wrap-around below one batch, negatives and sides; the
    host feed hands them to the step as int32 tensors."""
    data = dict(n_entities=N_ENT, n_relations=N_REL, n_train=n_train,
                n_valid=5, n_test=5, seed=seed)
    pds = synthetic_dataset(**data)
    jsam = JaxTrainSampler(jax_synthetic(**data), B, NEG, seed=seed)
    psam = TrainSampler(pds, B, NEG, seed=seed)
    feed = HostFeed(KEModel(KGEConfig(**_cfg()), N_ENT, N_REL,
                            device="cpu"), pds, B, NEG, seed=seed)
    for i in range(7):
        jb, pb = next(jsam), next(psam)
        assert pb["neg_head"] == jb["neg_head"] == (i % 2 == 0)
        for k in ("h", "r", "t", "neg"):
            np.testing.assert_array_equal(pb[k], jb[k])
        packed, impts, neg_head, b = feed.take(1)[0]
        h, r, t, neg = unpack_batch(packed, b)
        assert neg_head == pb["neg_head"] and impts is None
        for x, k in ((h, "h"), (r, "r"), (t, "t"), (neg, "neg")):
            assert x.dtype == torch.int32
            np.testing.assert_array_equal(x.numpy(), pb[k])


@pytest.mark.parametrize("n_train,route", [(10, "host-fed"),
                                           (31, "host-fed"),
                                           (32, "device-resident")])
def test_route_follows_two_batches(n_train, route):
    """Below 2 x batch_size the host-fed route trains (a dataset smaller
    than one batch too); from there the device pipeline."""
    ds = synthetic_dataset(N_ENT, N_REL, n_train=n_train, n_valid=5,
                           n_test=5, seed=1)
    init = KEModel(KGEConfig(**_cfg(seed=3)), N_ENT, N_REL,
                   device="cpu").init_state()
    state, logs = _run(ds)
    assert any(route in x for x in logs), logs
    assert state.step == 24
    losses = [float(x.rsplit(":", 1)[1]) for x in logs
              if "average loss" in x]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert not torch.equal(state.entity.emb, init.entity.emb)


def test_host_fed_async_with_edge_importance():
    """The host-fed route carries per-edge weights and async updates."""
    h, r, t = synthetic_dataset(N_ENT, N_REL, n_train=12, seed=2).train
    ds = synthetic_dataset(N_ENT, N_REL, n_train=12, seed=2)
    ds.train = (h, r, t, np.linspace(0.5, 2.0, 12).astype(np.float32))
    state, logs = _run(ds, async_update=True)
    assert any("host-fed" in x for x in logs)
    assert state.step == 24
