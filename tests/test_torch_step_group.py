"""The device pipeline's fused call (models/pipeline_step.py, the JAX
package's make_device_pipeline_step / DevicePipeline.run_call) on the CPU,
where every group runs eagerly:

  * a group's batches (DevicePipeline.begin_group / group_batches /
    end_group, from device tensors only) are next_batch's, bit for bit:
    s even and 1, groups and batches that straddle an epoch, a group that
    ends on one, edge weights;
  * train() through the fused call leaves the tables, the Adagrad state
    and the logs of the per-step loop, bit for bit (sync and
    --async_update; TransE_l2, TransR, RESCAL's factored route, RotatE);
  * one group agrees with the JAX package's steps on the same batches, with
    the JAX call's own async semantics (nothing pending at its start, the
    last update flushed at its end);
  * the group reads no device value on the host outside the kernel
    wrappers' plain versions (a CUDA graph could not capture such a read);
  * the launch counts a capture takes out and each replay adds back.

Tolerances: against the JAX package rtol 1e-5 / atol 1e-6 on tables and
Adagrad state (fp32 on both sides, sums in another order), as in
tests/test_torch_async.py; for TransR every row but those a component
within a few fp32 roundings of 0 touches (C4, as
tests/test_torch_host_table.py states it).  Within the port: exact.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax

from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.models.ke_model import KEModel as JaxModel
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import KGDataset, synthetic_dataset
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.models.pipeline_step import DevicePipelineStep
from dglke_tpu_torch.ops import outer_update, rows
from dglke_tpu_torch.trainer import DevicePipeline, steps_per_group, train
from dglke_tpu_torch.utils.convert import state_from_numpy
from test_torch_host_table import _transr_near_zero_rows

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
N_ENT, N_REL, DIM, B, NEG = 60, 4, 8, 16, 4
QUIET = lambda *a: None  # noqa: E731


def _cfg(**over):
    kw = dict(model_name="TransE_l2", hidden_dim=DIM, gamma=4.0, lr=0.25,
              batch_size=B, neg_sample_size=NEG, max_step=24,
              log_interval=12, neg_adversarial_sampling=True,
              regularization_coef=1e-3, seed=3)
    kw.update(over)
    if kw["model_name"] == "RotatE":
        kw.setdefault("double_ent", True)
    return KGEConfig(**kw)


def _dataset(n_train, weights=False, seed=1):
    ds = synthetic_dataset(N_ENT, N_REL, n_train=n_train, n_valid=5,
                           n_test=5, seed=seed)
    if weights:
        h, r, t = ds.train[:3]
        ds = KGDataset(name=ds.name, n_entities=N_ENT, n_relations=N_REL,
                       train=(h, r, t, np.linspace(
                           0.5, 2.0, n_train).astype(np.float32)),
                       valid=ds.valid, test=ds.test)
    return ds


def _pipe(ds, b=B, seed=5):
    model = KEModel(_cfg(batch_size=b), N_ENT, N_REL, device="cpu")
    return DevicePipeline(model, ds, b, (b // NEG) * NEG, seed=seed)


# ---------------------------------------------------------------------------
# The batch stream


@pytest.mark.parametrize("n_train,b,s,weights", [
    (40, 4, 4, False),     # groups of 16 straddle the 40-edge epoch
    (30, 4, 2, False),     # batches straddle it (30 = 7.5 batches)
    (48, 4, 4, False),     # groups end exactly on the epoch
    (10, 4, 1, False),     # s = 1, batches straddle
    (30, 4, 3, True),      # edge weights, s odd
    (64, 16, 4, True),     # one group a whole epoch
], ids=["even", "straddling_batch", "ends_on_epoch", "s1", "weights",
        "whole_epoch"])
def test_group_batches_are_next_batchs(n_train, b, s, weights):
    ds = _dataset(n_train, weights)
    steps, group = _pipe(ds, b), _pipe(ds, b)
    for _ in range(8):
        want = [steps.next_batch() for _ in range(s)]
        group.begin_group(s)
        got = group.group_batches(s)
        group.end_group(s)
        assert len(got) == s
        for g, w in zip(got, want):
            for x, y in zip(g[:5], w[:5]):
                if y is None:
                    assert x is None
                else:
                    assert x.dtype == y.dtype and torch.equal(x, y)
            assert g[5] == w[5]
        assert (group.epoch, group.pos, group.step_idx) == (
            steps.epoch, steps.pos, steps.step_idx)
        assert torch.equal(group.ring, steps.ring)
    assert steps.epoch >= 2


def test_step_group_must_fit_an_epoch():
    pipe = _pipe(_dataset(40))
    model = pipe.model
    with pytest.raises(ValueError, match="fit one epoch"):
        DevicePipelineStep(model, pipe, 3)       # 48 rows > 40 edges
    assert DevicePipelineStep(model, pipe, 2).s == 2


# ---------------------------------------------------------------------------
# Training through the fused call


def _step_loop(cfg, ds):
    """The per-step loop the trainer ran before the fused call: next_batch
    and train_step (or train_step_async, flushed at each group's end);
    returns the state and each log key's values, one a step."""
    model = KEModel(cfg, N_ENT, N_REL, device="cpu")
    state = model.init_state()
    pipe = DevicePipeline(model, ds, cfg.batch_size,
                          cfg.num_chunks * cfg.neg_sample_size, seed=cfg.seed)
    s = steps_per_group(cfg, ds.n_train, True, log=QUIET)
    use_async = cfg.async_update and s > 1
    logs = []
    for _ in range(cfg.max_step // s):
        pending = None
        for _ in range(s):
            h, r, t, neg, impts, neg_head = pipe.next_batch()
            if use_async:
                state, pending, log = model.train_step_async(
                    state, pending, h, r, t, neg, impts, neg_head=neg_head)
            else:
                state, log = model.train_step(state, h, r, t, neg, impts,
                                              neg_head=neg_head)
            logs.append(log)
        model.flush_async(state, pending)
    return state, {k: torch.stack([x[k] for x in logs]) for k in logs[0]}


@pytest.mark.parametrize("model_name", ["TransE_l2", "TransR", "RESCAL",
                                        "RotatE"])
@pytest.mark.parametrize("async_update", [False, True],
                         ids=["sync", "async"])
def test_train_through_the_fused_call_is_the_step_loop(model_name,
                                                       async_update,
                                                       monkeypatch):
    """100 edges at batch 16: s = 6, so groups and batches straddle the
    epochs; every group's logs are kept."""
    cfg = _cfg(model_name=model_name, async_update=async_update)
    ds = _dataset(100, weights=model_name == "TransE_l2")
    seen = []
    real_call = DevicePipelineStep.__call__

    def call(self, state, span=None):
        state, logs = real_call(self, state, span)
        seen.append(logs)
        return state, logs

    monkeypatch.setattr(DevicePipelineStep, "__call__", call)
    lines = []
    model, got, _ = train(cfg, ds, log=lines.append, device="cpu")
    assert "[proc 0]device-resident pipeline: 6 steps a group, each group " \
           "eagerly on the CPU" in lines
    assert model._rescal_factored(got) == (model_name == "RESCAL")
    want, want_logs = _step_loop(cfg, ds)
    assert len(seen) == 4 and got.step == want.step == 24
    for table in ("entity", "relation", "projection"):
        g, w = getattr(got, table), getattr(want, table)
        if w is None:
            assert g is None
            continue
        assert torch.equal(g.emb, w.emb) and torch.equal(g.state_sum,
                                                         w.state_sum)
    for k, v in want_logs.items():
        assert torch.equal(torch.cat([x[k] for x in seen]), v)


# ---------------------------------------------------------------------------
# One group against the JAX package's steps


def _close(got, want, skip=()):
    got, want = got.detach().numpy(), np.asarray(want)
    keep = np.ones(len(want), bool)
    keep[list(skip)] = False
    np.testing.assert_allclose(got[keep], want[keep], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("model_name", ["TransE_l2", "TransR", "RESCAL"])
@pytest.mark.parametrize("async_update", [False, True],
                         ids=["sync", "async"])
def test_one_group_matches_jax_steps(model_name, async_update):
    """A group of 4 steps of 16 rows, from the JAX package's initial
    tables, against the JAX package's train_step / train_step_async on the
    same batches, nothing pending at the group's start and the last update
    flushed at its end.  The pipeline has taken two steps before, so the
    group straddles the epoch of 72 edges."""
    s = 4
    kw = dict(model_name=model_name, hidden_dim=DIM, gamma=4.0, lr=0.25,
              batch_size=B, neg_sample_size=NEG,
              neg_adversarial_sampling=True, regularization_coef=1e-3,
              async_update=async_update)
    cfg = KGEConfig(**kw)
    jm = JaxModel(JaxConfig(**kw), N_ENT, N_REL)
    pm = KEModel(cfg, N_ENT, N_REL, device="cpu")
    jstate = jm.init_state(jax.random.PRNGKey(0))
    state = state_from_numpy(jax.device_get(jstate), device="cpu")
    ds = _dataset(72)
    neg_total = cfg.num_chunks * cfg.neg_sample_size
    pipe, twin = (DevicePipeline(pm, ds, B, neg_total, seed=2)
                  for _ in range(2))
    for p in (pipe, twin):
        p.next_batch()
        p.next_batch()
    twin.begin_group(s)
    batches = twin.group_batches(s)
    state, _ = DevicePipelineStep(pm, pipe, s)(state)
    assert pipe.epoch == 1 and state.step == s
    pending = jm._zero_pending(B, neg_total) if async_update else None
    skip = {"entity": set(), "relation": set()}
    for h, r, t, neg, impts, neg_head in batches:
        if pm.is_transr:
            host = jax.device_get(jstate)
            ents, rels = _transr_near_zero_rows(
                (host.entity, host.relation, host.projection),
                {"h": h.numpy(), "r": r.numpy(), "t": t.numpy(),
                 "neg": neg.numpy(), "neg_head": neg_head},
                cfg, cfg.num_chunks, cfg.neg_sample_size)
            skip["entity"] |= ents
            skip["relation"] |= rels
        args = [x.numpy() for x in (h, r, t, neg)] + [impts]
        if async_update:
            jstate, pending, _ = jm.train_step_async(jstate, pending, *args,
                                                     neg_head=neg_head)
        else:
            jstate, _ = jm.train_step(jstate, *args, neg_head=neg_head)
    if async_update:
        jstate = jm.flush_async(jstate, pending)
    jstate = jax.device_get(jstate)
    assert len(skip["entity"]) <= 4 and len(skip["relation"]) <= 2, skip
    for table, rows_skipped in (("entity", skip["entity"]),
                                ("relation", skip["relation"]),
                                ("projection", skip["relation"])):
        w = getattr(jstate, table, None)
        if w is None or getattr(state, table) is None:
            continue
        _close(getattr(state, table).emb, w.emb, rows_skipped)
        _close(getattr(state, table).state_sum, w.state_sum, rows_skipped)


# ---------------------------------------------------------------------------
# No host read of a device value


_HOST_READS = {"aten._local_scalar_dense", "aten.nonzero",
               "aten.masked_select", "aten._unique", "aten._unique2",
               "aten.unique_dim", "aten.unique_consecutive",
               "aten.unique_dim_consecutive", "aten.item"}


class _HostReads(TorchDispatchMode):
    """Records every op that reads a tensor's value on the host, or copies
    a device tensor to the CPU (which a run on the CPU cannot show; the
    capture on a card refuses it), outside the kernel wrappers' plain
    versions."""

    def __init__(self):
        super().__init__()
        self.plain = 0
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.replace("::", ".")
        src = args[1] if name == "aten.copy_" else args[0] if args else None
        dst = (args[0].device if name == "aten.copy_"
               else kwargs.get("device"))
        to_cpu = (name in ("aten._to_copy", "aten.copy_")
                  and isinstance(src, torch.Tensor)
                  and src.device.type != "cpu"
                  and dst is not None and torch.device(dst).type == "cpu")
        if not self.plain and (name in _HOST_READS or to_cpu):
            self.found.append(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("over", [
    dict(async_update=True),
    dict(model_name="RESCAL"),
    dict(model_name="TransR"),
    dict(model_name="RotatE"),
    dict(emb_dtype="bfloat16", compute_dtype="bfloat16"),
    dict(neg_deg_sample=True, regularization_norm=3),
], ids=["TransE_l2_async", "RESCAL", "TransR", "RotatE", "bf16",
        "neg_deg_sample"])
def test_group_reads_no_device_value(over, monkeypatch):
    cfg = _cfg(**over)
    model = KEModel(cfg, N_ENT, N_REL, device="cpu")
    state = model.init_state()
    pipe = DevicePipeline(model, _dataset(100, weights=True), B,
                          cfg.num_chunks * cfg.neg_sample_size, seed=1)
    fused = DevicePipelineStep(model, pipe, 6)
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
    with mode:
        fused(state)
    assert mode.found == []
    # the mode does see such a read where one is made
    with mode:
        torch.ones(3).sum().item()
    assert mode.found == ["aten._local_scalar_dense"]


# ---------------------------------------------------------------------------
# Launch counts under replay


# What a capture of a group of 10 steps counts: RESCAL's factored route
# (its relation gather with the sum and the product, one launch a step);
# TransE_l2 in fp32, whose fused loss route launches two kernels a step.
CAPTURED = {
    "RESCAL": {"gather_rows": 20, "gather_rows_pow_sum": 10,
               "gather_rows_matvec": 10, "group_ids": 20,
               "group_ids_tiles": 0,
               "sparse_adagrad_rows": 10, "scatter_add_rows": 0,
               "outer_adagrad_update": 10, "transe_l2_loss": 0},
    "TransE_l2": {"gather_rows": 20, "gather_rows_pow_sum": 0,
                  "gather_rows_matvec": 0, "group_ids": 20,
                  "group_ids_tiles": 0,
                  "sparse_adagrad_rows": 20, "scatter_add_rows": 0,
                  "outer_adagrad_update": 0, "transe_l2_loss": 20},
}


@pytest.mark.parametrize("model_name", list(CAPTURED))
def test_capture_counts_come_out_and_replays_add_them(model_name,
                                                      monkeypatch):
    monkeypatch.setattr(rows, "launches", dict.fromkeys(rows.launches, 0))
    rows.launches["gather_rows"] = 5
    before = dict(rows.launches)
    for k, n in CAPTURED[model_name].items():
        rows.launches[k] += n
    counted = rows.take_launches(before)
    assert rows.launches == before
    assert counted == CAPTURED[model_name]
    for _ in range(99):           # a run of 100 groups: 99 replays
        rows.add_launches(counted)
    want = dict(before)
    for k, n in counted.items():
        want[k] += 99 * n
    assert rows.launches == want
