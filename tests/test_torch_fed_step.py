"""The fed step (models/fed_step.py: a group of host-sampled batches a
call, the JAX package's packed step and superstep, and its host-table row
step) on the CPU, where every call runs eagerly:

  * host tables: train_host through the fed step leaves the tables, the
    Adagrad state and the logs of host_step's eager loop, bit for bit
    (TransE_l2, TransR's projection, RESCAL's row route, with and without
    edge weights; RotatE's checkpointed scores);
  * the host-fed route: train() through the fed step is the per-step
    HostFeed loop it replaced, bit for bit (s = 1, s > 1 with and without
    --async_update, edge weights);
  * both against the JAX package on the same batches from the same
    tables: the host-table row step and numpy Adagrad, the packed step at
    s = 1 and the packed superstep at s > 1 (its async semantics);
  * the memo key separates the corruption sides, edge weights and tables;
  * the route lines, and on a stand-in for the card (GroupCall.on_graphs
    true, a graph whose replay re-runs the group function) the graph lines,
    graphs and replays, with the tables still bit-equal;
  * nothing in a step moves or reads a value between the host and the
    device: the group function converts no numpy array and reads no
    device value.

Tolerances: against the JAX package rtol 1e-5 / atol 1e-6 on tables and
Adagrad state (fp32 on both sides, sums in another order), as in
tests/test_torch_host_table.py; for TransR every row but those a component
within a few fp32 roundings of 0 touches (C4, as that file states it).
Within the port: exact.
"""

import numpy as np
import pytest
import torch

import jax

import dglke_tpu.host_table as jht
from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.data.dataset import synthetic_dataset as jax_synthetic
from dglke_tpu.data.sampler import TrainSampler as JaxTrainSampler
from dglke_tpu.models.ke_model import KEModel as JaxModel
import dglke_tpu_torch.host_table as pht
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import synthetic_dataset
from dglke_tpu_torch.data.sampler import TrainSampler
from dglke_tpu_torch.models import cuda_graphs
from dglke_tpu_torch.models.fed_step import FedStep, pack_batch, unpack_batch
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.ops import outer_update, rows
from dglke_tpu_torch.trainer import steps_per_group, train
from dglke_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from test_torch_host_table import _transr_near_zero_rows
from test_torch_step_group import _HostReads

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
N_ENT, N_REL, DIM, B, NEG = 60, 4, 8, 16, 4
QUIET = lambda *a: None  # noqa: E731


def _kw(**over):
    kw = dict(model_name="TransE_l2", hidden_dim=DIM, gamma=4.0, lr=0.25,
              batch_size=B, neg_sample_size=NEG, max_step=12,
              log_interval=6, neg_adversarial_sampling=True,
              regularization_coef=1e-3, seed=3)
    kw.update(over)
    if kw["model_name"] == "RotatE":
        kw.setdefault("double_ent", True)
    return kw


def _datasets(n_train, weights=False, seed=1):
    """The port's and the JAX package's copies of one synthetic dataset,
    with edge weights when asked."""
    data = dict(n_entities=N_ENT, n_relations=N_REL, n_train=n_train,
                n_valid=5, n_test=5, seed=seed)
    pds, jds = synthetic_dataset(**data), jax_synthetic(**data)
    if weights:
        w = np.linspace(0.5, 2.0, n_train).astype(np.float32)
        pds.train = pds.train[:3] + (w,)
        jds.train = jds.train[:3] + (w.copy(),)
    return pds, jds


def _copy(state):
    """A TrainState of copies of ``state``'s tables, on the CPU."""
    return state_from_numpy(state_to_numpy(state), device="cpu")


def _same_tables(got, want):
    for table in ("entity", "relation", "projection"):
        g, w = getattr(got, table), getattr(want, table)
        if w is None:
            assert g is None
            continue
        assert torch.equal(g.emb, w.emb), table
        assert torch.equal(g.state_sum, w.state_sum), table


def _keep_logs(monkeypatch):
    """Every fed call's logs, in call order."""
    seen = []
    real = FedStep.__call__

    def call(self, *args, **kwargs):
        state, logs = real(self, *args, **kwargs)
        seen.append(logs)
        return state, logs

    monkeypatch.setattr(FedStep, "__call__", call)
    return seen


# ---------------------------------------------------------------------------
# Host tables: the fed step against host_step's eager loop


def _host_copy(state):
    def table(t):
        return None if t is None else pht.HostEmbedding(
            t.emb.clone(), t.state_sum.clone())
    return pht.HostState(table(state.entity), table(state.relation),
                         table(state.projection), state.step)


@pytest.mark.parametrize("model_name,weights", [
    ("TransE_l2", False), ("TransE_l2", True), ("TransR", False),
    ("RESCAL", True), ("RotatE", False)])
def test_train_host_through_the_fed_step_is_host_steps_loop(
        model_name, weights, monkeypatch):
    cfg = KGEConfig(**_kw(model_name=model_name, mix_cpu_gpu=True))
    ds, _ = _datasets(100, weights)
    model = KEModel(cfg, N_ENT, N_REL, device="cpu")
    init = pht.init_host_state(model, cfg.seed)
    seen = _keep_logs(monkeypatch)
    lines = []
    _, got, _ = pht.train_host(cfg, ds, model=model, state=_host_copy(init),
                               log=lines.append)
    assert "[proc 0]host tables: each step eagerly on the CPU" in lines
    assert not any("CUDA graphs" in x for x in lines)
    assert sum(x.startswith("[proc 0]sample: ") for x in lines) == 2

    want = _host_copy(init)
    sampler = TrainSampler(ds, B, NEG, seed=cfg.seed)
    logs = [pht.host_step(model, want, next(sampler))
            for _ in range(cfg.max_step)]
    assert got.step == want.step == cfg.max_step
    _same_tables(got, want)
    assert len(seen) == cfg.max_step
    for k in logs[0]:
        assert torch.equal(torch.cat([x[k] for x in seen]),
                           torch.stack([x[k] for x in logs]))


# ---------------------------------------------------------------------------
# The host-fed route: the fed step against the per-step HostFeed loop


def _host_fed_loop(cfg, ds, state, model):
    """The host-fed loop the trainer ran before the fed step: one packed
    TrainSampler batch a step, moved to the model's device, through
    train_step (or train_step_async, flushed at each group's end)."""
    s = steps_per_group(cfg, ds.n_train, ds.n_train >= 2 * cfg.batch_size,
                        log=QUIET)
    use_async = cfg.async_update and s > 1
    sampler = TrainSampler(ds, cfg.batch_size, cfg.neg_sample_size,
                           seed=cfg.seed)
    logs = []
    for _ in range(cfg.max_step // s):
        pending = None
        for _ in range(s):
            packed, impts, neg_head, b = pack_batch(next(sampler), False)
            h, r, t, neg = unpack_batch(packed.to(model.device), b)
            if use_async:
                state, pending, log = model.train_step_async(
                    state, pending, h, r, t, neg, impts, neg_head=neg_head)
            else:
                state, log = model.train_step(state, h, r, t, neg, impts,
                                              neg_head=neg_head)
            logs.append(log)
        model.flush_async(state, pending)
    return state, s, {k: torch.stack([x[k] for x in logs]) for k in logs[0]}


@pytest.mark.parametrize("model_name,n_train,max_step,over,s", [
    ("TransE_l2", 100, 7, {}, 1),                       # C6: odd max_step
    ("RESCAL", 100, 7, {}, 1),
    ("TransE_l2", 24, 12, {}, 6),                       # under two batches
    ("TransE_l2", 24, 12, dict(async_update=True), 6),
    ("TransR", 24, 12, dict(async_update=True), 6),
    ("RESCAL", 10, 12, {}, 6),
], ids=["s1", "s1_RESCAL", "sync", "async", "async_TransR", "RESCAL"])
def test_host_fed_route_through_the_fed_step_is_the_step_loop(
        model_name, n_train, max_step, over, s, monkeypatch):
    cfg = KGEConfig(**_kw(model_name=model_name, max_step=max_step,
                          log_interval=max_step if s == 1 else 6, **over))
    ds, _ = _datasets(n_train, weights=model_name == "TransE_l2")
    model = KEModel(cfg, N_ENT, N_REL, device="cpu")
    init = model.init_state()
    seen = _keep_logs(monkeypatch)
    lines = []
    _, got, _ = train(cfg, ds, model=model, state=_copy(init),
                      log=lines.append)
    assert any("host-fed TrainSampler" in x and f": {s} steps a group" in x
               for x in lines), lines
    assert not any("CUDA graphs" in x for x in lines)
    want, want_s, want_logs = _host_fed_loop(cfg, ds, _copy(init), model)
    assert want_s == s and len(seen) == max_step // s
    assert got.step == want.step == max_step
    _same_tables(got, want)
    for k, v in want_logs.items():
        assert torch.equal(torch.cat([x[k] for x in seen]), v)


# ---------------------------------------------------------------------------
# Against the JAX package


def _close(got, want, skip=()):
    got, want = got.detach().numpy(), np.asarray(want)
    keep = np.ones(len(want), bool)
    keep[sorted(skip)] = False
    np.testing.assert_allclose(got[keep], want[keep], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("model_name,weights", [
    ("TransE_l2", True), ("TransR", False), ("RESCAL", False)])
def test_host_fed_step_matches_jax_row_steps(model_name, weights):
    """10 TrainSampler batches; before each, the port's host tables are set
    to the JAX package's, then the port takes one fed host step and the JAX
    package its train_host's loop body (make_host_rows_step and numpy
    Adagrad)."""
    cfg = KGEConfig(**_kw(model_name=model_name, mix_cpu_gpu=True))
    jcfg = JaxConfig(**_kw(model_name=model_name, mix_cpu_gpu=True))
    _, jds = _datasets(100, weights)
    model = KEModel(cfg, N_ENT, N_REL, device="cpu")
    jm = JaxModel(jcfg, N_ENT, N_REL)
    want = jht.init_host_state(jm, cfg.seed)
    sampler = JaxTrainSampler(jds, B, NEG, seed=cfg.seed)
    step_fn = jm.make_host_rows_step(B, sampler.num_chunks * NEG)
    fused = pht.host_fed_step(model)
    for i in range(10):
        batch = next(sampler)
        tables = (want.entity, want.relation, want.projection)
        ents, rels = (_transr_near_zero_rows(tables, batch, cfg,
                                             sampler.num_chunks, NEG)
                      if model.is_transr else (set(), set()))
        assert len(ents) <= 4 and len(rels) <= 2, (ents, rels)
        got = pht.HostState(*(None if t is None else pht.HostEmbedding(
            torch.from_numpy(t.emb.copy()),
            torch.from_numpy(t.state_sum.copy())) for t in tables))
        _, plog = fused(got, [pack_batch(batch, False)], i)
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
        for name, skip in (("entity", ents), ("relation", rels),
                           ("projection", rels)):
            w = getattr(want, name)
            if w is not None:
                _close(getattr(got, name).emb, w.emb, skip)
                _close(getattr(got, name).state_sum, w.state_sum, skip)
        np.testing.assert_allclose(float(plog["loss"][0]),
                                   float(jlog["loss"]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model_name,s,async_update", [
    ("TransE_l2", 1, False), ("RESCAL", 1, False), ("TransE_l2", 4, False),
    ("TransE_l2", 4, True), ("DistMult", 4, False), ("RESCAL", 4, True)],
    ids=["packed", "packed_RESCAL", "superstep", "superstep_async",
         "superstep_DistMult", "superstep_async_RESCAL"])
def test_fed_call_matches_jax_packed_calls(model_name, s, async_update):
    """One fed call of s TrainSampler batches (edge weights on TransE_l2),
    from the JAX package's initial tables, against its packed step (s = 1)
    or packed superstep (s > 1: nothing pending at the call's start, the
    last update flushed at its end) on the same packed batches."""
    kw = _kw(model_name=model_name, async_update=async_update)
    cfg, jcfg = KGEConfig(**kw), JaxConfig(**kw)
    ds, _ = _datasets(24, weights=model_name == "TransE_l2")
    jm = JaxModel(jcfg, N_ENT, N_REL)
    pm = KEModel(cfg, N_ENT, N_REL, device="cpu")
    jstate = jax.device_get(jm.init_state(jax.random.PRNGKey(0)))
    state = state_from_numpy(jstate, device="cpu")
    sampler = TrainSampler(ds, B, NEG, seed=5)
    raw = [next(sampler) for _ in range(s)]
    batches = [pack_batch(x, False) for x in raw]
    state, plog = FedStep(pm, s)(state, batches)
    assert state.step == s
    packed = np.stack([x[0].numpy() for x in batches])
    impts = (None if raw[0]["impts"] is None
             else np.stack([x["impts"] for x in raw]))
    if s == 1:
        jout, jlog = jm.make_train_step_packed(B, donate=False)(
            jstate, packed[0], None if impts is None else impts[0],
            neg_head=raw[0]["neg_head"])
    else:
        jout, jlog = jm.make_train_superstep(B, s, donate=False)(
            jstate, packed, impts)
    jout = jax.device_get(jout)
    for table in ("entity", "relation"):
        w = getattr(jout, table)
        _close(getattr(state, table).emb, w.emb)
        _close(getattr(state, table).state_sum, w.state_sum)
    np.testing.assert_allclose(float(plog["loss"].mean()),
                               float(jlog["loss"]), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The memo key


def test_memo_key_separates_sides_weights_and_tables():
    cfg = KGEConfig(**_kw())
    ds, _ = _datasets(24, weights=True)
    model = KEModel(cfg, N_ENT, N_REL, device="cpu")
    state = model.init_state()
    raw = [next(iter(TrainSampler(ds, B, NEG, seed=s))) for s in (1, 2)]
    fed = FedStep(model, 2)

    def key(batches, st=state):
        fed._stage(batches)
        return fed._key(st)

    head, tail = raw[0], dict(raw[1], neg_head=False)
    weighted = [pack_batch(x, False) for x in (head, tail)]
    plain = [pack_batch(dict(x, impts=None), False) for x in (head, tail)]
    k = key(weighted)
    assert k == key([pack_batch(x, False) for x in (dict(head), tail)])
    assert k != key(weighted[::-1])                          # sides
    assert k != key([pack_batch(dict(x, neg_head=True), False)
                     for x in (head, tail)])
    assert k != key(plain)                                   # weights
    other = _copy(state)    # tables
    assert k != key(weighted, other)
    assert key(weighted, other) == key(weighted, other)
    with pytest.raises(ValueError, match="takes 2 batches"):
        fed._stage(weighted[:1])


# ---------------------------------------------------------------------------
# The graph route on a stand-in for the card


class _FakeGraph:
    """A replay that re-runs the group function into the captured output,
    counting no launch (a real replay runs no Python)."""

    def __init__(self, fn, out, state):
        self.fn, self.out, self.state = fn, out, state

    def replay(self):
        before, step = dict(rows.launches), self.state.step
        self.out.copy_(self.fn())
        rows.launches.update(before)
        self.state.step = step


def _stand_in_card(monkeypatch, state):
    """GroupCall on a stand-in card: the first call eagerly, a capture that
    runs nothing on ``state``'s tables (it runs the group function on them
    and puts them back), replays of _FakeGraph."""
    monkeypatch.setattr(cuda_graphs.GroupCall, "on_graphs",
                        property(lambda self: True))
    monkeypatch.setattr(cuda_graphs, "run_on_capture_stream",
                        lambda device, fn: ("stream", fn()))

    def capture(fn, stream, pool=None, generators=()):
        assert stream == "stream"
        tables = [x for t in (state.entity, state.relation, state.projection)
                  if t is not None for x in (t.emb, t.state_sum)]
        saved = [x.clone() for x in tables]
        before = dict(rows.launches)
        out = fn()
        for x, y in zip(tables, saved):
            x.copy_(y)
        return _FakeGraph(fn, out, state), out, rows.take_launches(before)

    monkeypatch.setattr(cuda_graphs, "capture", capture)


def test_host_tables_on_the_stand_in_card(monkeypatch):
    """train_host logs the graph route and its graphs: two at s = 1
    (head-first and tail-first steps), a replay every step after the first;
    the tables those of host_step's eager loop."""
    cfg = KGEConfig(**_kw(model_name="TransR", mix_cpu_gpu=True, max_step=9,
                          log_interval=9))
    ds, _ = _datasets(100)
    model = KEModel(cfg, N_ENT, N_REL, device="cpu")
    init = pht.init_host_state(model, cfg.seed)
    state = _host_copy(init)
    _stand_in_card(monkeypatch, state)
    lines = []
    pht.train_host(cfg, ds, model=model, state=state, log=lines.append)
    assert "[proc 0]host tables: one CUDA graph a step" in lines
    assert "[proc 0]CUDA graphs: 2 captured, 8 replays" in lines
    want = _host_copy(init)
    sampler = TrainSampler(ds, B, NEG, seed=cfg.seed)
    for _ in range(cfg.max_step):
        pht.host_step(model, want, next(sampler))
    assert state.step == want.step == 9
    _same_tables(state, want)


@pytest.mark.parametrize("n_train,max_step,over,want", [
    (100, 7, {}, (1, 2, 6)), (24, 24, dict(async_update=True), (6, 1, 3))],
    ids=["s1", "async"])
def test_host_fed_route_on_the_stand_in_card(n_train, max_step, over, want,
                                             monkeypatch):
    cfg = KGEConfig(**_kw(max_step=max_step, log_interval=7 if max_step == 7
                          else 6, **over))
    ds, _ = _datasets(n_train)
    model = KEModel(cfg, N_ENT, N_REL, device="cpu")
    init = model.init_state()
    state = _copy(init)
    _stand_in_card(monkeypatch, state)
    lines = []
    train(cfg, ds, model=model, state=state, log=lines.append)
    s, graphs, replays = want
    assert any(f": {s} steps a group" in x and "host-fed" in x
               for x in lines), lines
    assert (f"[proc 0]CUDA graphs: {graphs} captured, {replays} replays"
            in lines), lines
    monkeypatch.undo()
    eager, _, _ = _host_fed_loop(cfg, ds, _copy(init), model)
    assert state.step == eager.step == max_step
    _same_tables(state, eager)


# ---------------------------------------------------------------------------
# Nothing moves between the host and the device inside a step (the
# refusal of a batch off the model's device on host tables:
# tests/test_torch_train_step.py)


@pytest.mark.parametrize("route", ["host tables", "host-fed",
                                   "host-fed async"])
def test_fed_group_reads_and_uploads_nothing(route, monkeypatch):
    """The group function, on staged batches, converts no numpy array and
    reads no device value on the host (outside the kernel wrappers' plain
    versions): what a capture could not hold."""
    host = route == "host tables"
    cfg = KGEConfig(**_kw(model_name="RESCAL", mix_cpu_gpu=host,
                          async_update=route.endswith("async")))
    ds, _ = _datasets(24, weights=True)
    model = KEModel(cfg, N_ENT, N_REL, device="cpu")
    if host:
        state, fed = (pht.init_host_state(model, cfg.seed),
                      pht.host_fed_step(model))
    else:
        state, fed = model.init_state(), FedStep(model, 4)
    sampler = TrainSampler(ds, B, NEG, seed=2)
    fed._stage([pack_batch(next(sampler), False) for _ in range(fed.s)])
    mode = _HostReads()
    plains = [(rows, name) for name in (
        "gather_rows_plain", "sparse_adagrad_plain", "scatter_add_plain",
        "group_ids_plain")] + [(outer_update, "outer_adagrad_plain")]
    for module, name in plains:
        real = getattr(module, name)

        def plain(*args, _real=real, **kwargs):
            mode.plain += 1
            try:
                return _real(*args, **kwargs)
            finally:
                mode.plain -= 1

        monkeypatch.setattr(module, name, plain)

    def no_numpy(*args):
        raise AssertionError("a numpy array converted inside the step")

    with monkeypatch.context() as mp:
        mp.setattr(torch, "from_numpy", no_numpy)
        with mode:
            fed.group(state)
    assert mode.found == []
    assert state.step == fed.s
