"""The --dist step group (models/pipeline_step.py under a ShardingPlan, the
JAX package's make_device_pipeline_step_multihost) and the vocab plan's
fixed-capacity route, on two gloo ranks on the CPU, where each group runs
eagerly as one call.  TransE_l2 and RESCAL, both plans, 43 entities (an
odd count: one shard is padded), dim 16:

  * a group of s = 4 (--async_update off and on) and a run of s = 1
    leave each rank's tables bit-equal to the same steps taken one by one
    from the same DevicePipeline state (next_batch, then train_step or
    train_step_async with the last update flushed at the group's end);
  * a batch whose ids all belong to one owner (the other receives only
    pad slots) and a batch whose every id belongs to the other rank (no
    rank sends itself an id) leave the tables within rtol 1e-5 / atol
    1e-6 of one device's step on the global batch (RESCAL atol 5e-6, as
    tests/test_torch_dist_step.py states it), and every row that no id of
    the batch touches bit-equal;
  * the routed gather and update read nothing on the host: with
    Tensor.tolist, Tensor.item and torch.bincount raising inside them,
    the steps still run;
  * train() under a plan runs the fused call, each group eagerly over
    gloo, at one step a group where two batches exceed a partition;
  * which calls a card would capture under a plan (NCCL: yes; gloo, the
    CPU: no), with stand-in comms and no process group.
"""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_util import results, run_ranks  # noqa: E402

W = 2
N_ENT, N_REL, DIM, B, NEG = 43, 5, 16, 8, 4   # B rows, B negatives a rank
PER = -(-N_ENT // W)
BASE = dict(hidden_dim=DIM, lr=0.25, batch_size=B, neg_sample_size=NEG,
            neg_adversarial_sampling=True, regularization_coef=1e-3,
            regularization_norm=3, seed=7)
FAMILIES = {"TransE_l2": dict(gamma=4.0), "RESCAL": dict(gamma=8.0)}
ATOL = {"TransE_l2": 1e-6, "RESCAL": 5e-6}
PLANS = ("vocab", "replicated")
# (steps a group, --async_update, groups)
GROUPS = {"s4": (4, False, 2), "s4-async": (4, True, 2), "s1": (1, False, 3)}
# Two global batches of W*B rows and W*B negatives: "one-owner" draws every
# id from rank 0's shard, "crossed" gives rank 0 ids of rank 1's shard only
# and rank 1 ids of rank 0's.
BATCHES = ("one-owner", "crossed")

_WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import synthetic_dataset
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.models.pipeline_step import DevicePipelineStep
from dglke_tpu_torch.parallel.mesh import ShardingPlan, init_distributed
from dglke_tpu_torch.trainer import DevicePipeline, train
from dglke_tpu_torch.utils.convert import (NumpyState, NumpyTable,
                                           state_from_numpy, state_to_numpy)

root = sys.argv[1]
comm = init_distributed("cpu")
rank, world = comm.rank, comm.world
spec = json.load(open(f"{root}/spec.json"))
out = {"backend": comm.backend, "lines": {}, "guarded": 0}


def host_read(*a, **k):
    raise AssertionError("a host read in the routed exchange")


def no_host_reads(fn):
    # Tensor.tolist / Tensor.item / torch.bincount raise while fn runs
    def guarded(*a, **k):
        out["guarded"] += 1
        saved = (torch.Tensor.tolist, torch.Tensor.item, torch.bincount)
        torch.Tensor.tolist = torch.Tensor.item = host_read
        torch.bincount = host_read
        try:
            return fn(*a, **k)
        finally:
            torch.Tensor.tolist, torch.Tensor.item, torch.bincount = saved
    return guarded


for name in ("routed_gather", "routed_update"):
    setattr(ShardingPlan, name, no_host_reads(getattr(ShardingPlan, name)))


def save(path, state):
    o = state_to_numpy(state)
    np.savez(path, ent=o.entity.emb, ent_ss=o.entity.state_sum,
             rel=o.relation.emb, rel_ss=o.relation.state_sum,
             step=np.asarray(o.step))


def tables(z):
    def tab(k):
        return NumpyTable(z[k], z[k + "_ss"])
    return state_from_numpy(NumpyState(tab("ent"), tab("rel"),
                                       np.asarray(3, np.int32), None),
                            device="cpu")


ds = synthetic_dataset(spec["n_ent"], spec["n_rel"], n_train=200,
                       n_valid=5, n_test=5, seed=rank)
for family, cfgd in spec["cfgs"].items():
    z = np.load(f"{root}/{family}.npz")
    for ts in spec["plans"]:
        # a group against its steps one by one, from the same pipeline
        for gname, (s, use_async, groups) in spec["groups"].items():
            cfg = KGEConfig(**dict(cfgd, async_update=use_async))
            plan = ShardingPlan(comm, ts, spec["n_ent"])
            model = KEModel(cfg, spec["n_ent"], spec["n_rel"], plan=plan)
            neg_total = cfg.num_chunks * cfg.neg_sample_size
            pipes = [DevicePipeline(model, ds, cfg.batch_size, neg_total,
                                    seed=cfg.seed, rank=rank)
                     for _ in range(2)]
            fused = DevicePipelineStep(model, pipes[0], s)
            grouped = plan.shard_state(tables(z))
            for _ in range(groups):
                grouped, _ = fused(grouped)
            stepped = plan.shard_state(tables(z))
            for _ in range(groups):
                pending = None
                for _ in range(s):
                    h, r, t, neg, impts, nh = pipes[1].next_batch()
                    if use_async and s > 1:
                        _, pending, _ = model.train_step_async(
                            stepped, pending, h, r, t, neg, impts,
                            neg_head=nh)
                    else:
                        model.train_step(stepped, h, r, t, neg, impts,
                                         neg_head=nh)
                model.flush_async(stepped, pending)
            assert not fused.on_graphs
            tag = f"{family}-{ts}-{gname}"
            save(f"{root}/{tag}.group.rank{rank}.npz", grouped)
            save(f"{root}/{tag}.steps.rank{rank}.npz", stepped)
        # the skewed batches, against one device's step on rank 0
        for bname in spec["batches"]:
            cfg = KGEConfig(**cfgd)
            plan = ShardingPlan(comm, ts, spec["n_ent"])
            model = KEModel(cfg, spec["n_ent"], spec["n_rel"], plan=plan)
            state = plan.shard_state(tables(z))
            b = np.load(f"{root}/{bname}.npz")
            glob = [torch.from_numpy(b[k]) for k in ("h", "r", "t", "neg")]
            mine = [x[rank * len(x) // world:(rank + 1) * len(x) // world]
                    for x in glob]
            model.train_step(state, *mine, None, neg_head=True)
            save(f"{root}/{family}-{ts}-{bname}.rank{rank}.npz", state)
            if rank == 0 and ts == spec["plans"][0]:
                one = KEModel(cfg, spec["n_ent"], spec["n_rel"],
                              device="cpu")
                st = tables(z)
                one.train_step(st, *glob, None, neg_head=True)
                save(f"{root}/{family}-{bname}.single.npz", st)

# train() under a plan: its route line, a group of s steps a call, and
# one step a group where two batches exceed the smallest partition
for n_train, max_step in ((200, 8), (12, 3)):
    cfg = KGEConfig(**dict(spec["cfgs"]["TransE_l2"], max_step=max_step,
                           log_interval=max_step, steps_per_call=4))
    plan = ShardingPlan(comm, "vocab", spec["n_ent"])
    lines = []
    part = synthetic_dataset(spec["n_ent"], spec["n_rel"], n_train=n_train,
                             n_valid=5, n_test=5, seed=rank)
    _, state, _ = train(cfg, part, plan=plan, log=lines.append)
    assert state.step == max_step, state.step
    out["lines"][str(n_train)] = lines
print("RESULT " + json.dumps(out))
comm.close()
"""


def _cfg(family):
    return dict(BASE, model_name=family, **FAMILIES[family])


def _tables(family, seed=0):
    """Random numpy tables at the family's widths (state_sum nonzero)."""
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.models.ke_model import KEModel
    m = KEModel(KGEConfig(**_cfg(family)), N_ENT, N_REL, device="cpu")
    rng = np.random.default_rng(seed)
    out = {}
    for key, n, d in (("ent", N_ENT, m.entity_dim),
                      ("rel", N_REL, m.relation_dim)):
        out[key] = (rng.standard_normal((n, d)) * 0.3).astype(np.float32)
        out[key + "_ss"] = np.abs(rng.standard_normal(n)).astype(np.float32)
    return out


def _batch(name, seed=1):
    """A global batch of W*B rows and W*B negatives (rank r's part is the
    r-th slice of each) with repeated ids."""
    rng = np.random.default_rng(seed)

    def ids(lo, hi, n):
        return rng.integers(lo, hi, n).astype(np.int32)

    if name == "one-owner":
        ent = [ids(0, PER, W * B) for _ in range(3)]
    else:   # rank 0's slice from rank 1's shard, rank 1's from rank 0's
        ent = [np.concatenate([ids(PER, N_ENT, B), ids(0, PER, B)])
               for _ in range(3)]
    h, t, neg = ent
    h[1] = h[0]
    return dict(h=h, r=ids(0, N_REL, W * B), t=t, neg=neg)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_group"))
    for family in FAMILIES:
        np.savez(f"{root}/{family}.npz", **_tables(family))
    for name in BATCHES:
        np.savez(f"{root}/{name}.npz", **_batch(name))
    with open(f"{root}/spec.json", "w") as f:
        json.dump(dict(n_ent=N_ENT, n_rel=N_REL, plans=PLANS,
                       groups=GROUPS, batches=BATCHES,
                       cfgs={k: _cfg(k) for k in FAMILIES}), f)
    res = results(run_ranks(lambda r: ["-c", _WORKER, root], W,
                            timeout=400.0))
    return root, res


def _load(root, name):
    return dict(np.load(f"{root}/{name}.npz"))


@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_group_is_bit_equal_to_its_steps_one_by_one(run, family, plan,
                                                    group):
    root, _ = run
    s, _, groups = GROUPS[group]
    for rank in range(W):
        got = _load(root, f"{family}-{plan}-{group}.group.rank{rank}")
        want = _load(root, f"{family}-{plan}-{group}.steps.rank{rank}")
        assert int(got["step"]) == int(want["step"]) == 3 + s * groups
        for key in ("ent", "ent_ss", "rel", "rel_ss"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_skewed_batch_matches_one_device(run, family, plan, batch):
    root, _ = run
    r0, r1 = (_load(root, f"{family}-{plan}-{batch}.rank{r}")
              for r in range(W))
    got = dict(r0)
    if plan == "vocab":
        for k in ("ent", "ent_ss"):
            got[k] = np.concatenate([r0[k], r1[k]])[:N_ENT]
        # rank 1's pad row is never touched
        assert not r1["ent"][N_ENT - PER:].any()
    one = _load(root, f"{family}-{batch}.single")
    for key in ("ent", "ent_ss", "rel", "rel_ss"):
        np.testing.assert_allclose(got[key], one[key], rtol=1e-5,
                                   atol=ATOL[family], err_msg=key)
    init = _tables(family)
    b = _batch(batch)
    untouched = np.setdiff1d(np.arange(N_ENT),
                             np.concatenate([b["h"], b["t"], b["neg"]]))
    assert untouched.size > 10
    for key in ("ent", "ent_ss"):
        np.testing.assert_array_equal(got[key][untouched],
                                      init[key][untouched], err_msg=key)


def test_the_skewed_batches_are_what_they_claim():
    """one-owner: every id on rank 0's shard; crossed: no rank's slice
    holds an id of its own shard."""
    one, crossed = _batch("one-owner"), _batch("crossed")
    for k in ("h", "t", "neg"):
        assert (one[k] < PER).all()
        assert (crossed[k][:B] >= PER).all() and (crossed[k][B:] < PER).all()


def test_train_under_a_plan_runs_the_fused_call_eagerly_over_gloo(run):
    _, res = run
    assert [r["backend"] for r in res] == ["gloo"] * W
    lines = res[0]["lines"]
    assert ("[proc 0]device-resident pipeline: 4 steps a group, 2 ranks x "
            f"{B} rows a step, each group eagerly (gloo)") in lines["200"]
    assert ("[proc 0]device-resident pipeline: 1 steps a group, 2 ranks x "
            f"{B} rows a step, each group eagerly (gloo)") in lines["12"]
    for got in lines.values():
        assert not any("CUDA graphs" in x for x in got)
        assert any("average loss" in x for x in got)
    assert res[1]["lines"] == {"200": [], "12": []}   # logs on rank 0 only


def test_routed_exchange_reads_nothing_on_the_host(run):
    """Every routed gather and update of the worker ran with Tensor.tolist,
    Tensor.item and torch.bincount raising (and the steps ran)."""
    _, res = run
    for r in res:
        assert r["guarded"] > 100


def _plan(backend):
    return SimpleNamespace(comm=SimpleNamespace(backend=backend))


class _Model:   # what GroupCall and EvalCalls read of a KEModel
    def __init__(self, device, plan):
        self.device, self.plan = device, plan


@pytest.mark.parametrize("backend,device,want", [
    ("nccl", "cuda", True), ("gloo", "cuda", False), (None, "cuda", True),
    ("gloo", "cpu", False), (None, "cpu", False)])
def test_which_calls_replay_graphs_under_a_plan(backend, device, want):
    """GroupCall.on_graphs and EvalCalls.on_graphs: on a card without a
    plan or with one over NCCL; never over gloo, never on the CPU."""
    from dglke_tpu_torch.models.cuda_graphs import GroupCall
    from dglke_tpu_torch.models.eval_step import EvalCalls
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        "cpu")
    plan = None if backend is None else _plan(backend)
    assert GroupCall(dev, 4, plan).on_graphs is want
    model = _Model(dev, plan)
    assert EvalCalls(model).on_graphs(SimpleNamespace()) is want
