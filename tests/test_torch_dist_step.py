"""The port's 2-rank step under both sharding plans against the JAX
package's step on a 2-device mesh (ShardingPlan(make_mesh(2), ...) on the
virtual CPU devices of tests/conftest.py), from the same numpy tables and
the same global batch, each rank stepping on its slice of it; and against
the port's own single-device step on the global batch.  Two steps (head-
then tail-corrupt) of TransE_l2, TransR and RESCAL, on 43 entities (an odd
count: one shard is padded).

Tolerance: fp32 rtol 1e-5 / atol 1e-6 (the summation orders differ);
RESCAL atol 5e-6, since the JAX package takes its materialized route
under a plan and the port its factored one (tests/test_torch_families.py
holds the two routes to the same).  Replicated tables are bit-identical
across ranks.  The plan's collective bytes per step, summed over the
ranks, follow the formula written out below and do not change when the
entity table grows tenfold.  With --async_update (the entity update of
each step applied after the next step's gather, the last one flushed) the
2-rank steps agree with one device's under both plans.
"""

import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.models.ke_model import KEModel as JaxModel
from dglke_tpu.models.ke_model import TrainState as JaxState
from dglke_tpu.ops.embedding import EmbeddingState as JaxTable
from dglke_tpu.parallel.mesh import ShardingPlan as JaxPlan
from dglke_tpu.parallel.mesh import make_mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_util import results, run_ranks  # noqa: E402

W = 2
N_ENT, N_REL, DIM, B, NEG = 43, 5, 16, 8, 4   # B rows, B negatives a rank
BASE = dict(hidden_dim=DIM, lr=0.25, batch_size=B, neg_sample_size=NEG,
            neg_adversarial_sampling=True, regularization_coef=1e-3,
            regularization_norm=3)
FAMILIES = {"TransE_l2": dict(gamma=4.0), "TransR": dict(gamma=4.0),
            "RESCAL": dict(gamma=8.0)}
ATOL = {"TransE_l2": 1e-6, "TransR": 1e-6, "RESCAL": 5e-6}
PLANS = ("vocab", "replicated")
# the collective-bytes cases: TransE_l2 on a table 10x larger, same batch
BIG = 10 * N_ENT

_WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.parallel.mesh import ShardingPlan, init_distributed
from dglke_tpu_torch.utils.convert import (NumpyState, NumpyTable,
                                           state_from_numpy, state_to_numpy)

root = sys.argv[1]
comm = init_distributed("cpu")
rank, world = comm.rank, comm.world
cases = json.load(open(f"{root}/cases.json"))
sizes = {}
for case in cases:
    name, ts, n_ent = case["name"], case["plan"], case["n_ent"]
    z = np.load(f"{root}/{name}.npz")

    def full():
        def tab(k):
            return NumpyTable(z[k], z[k + "_ss"])
        return state_from_numpy(NumpyState(
            tab("ent"), tab("rel"), np.asarray(3, np.int32),
            tab("proj") if "proj" in z else None), device="cpu")

    cfg = KGEConfig(**case["cfg"])
    n_rel = z["rel"].shape[0]
    plan = ShardingPlan(comm, ts, n_ent)
    model = KEModel(cfg, n_ent, n_rel, plan=plan)
    state = plan.shard_state(full())
    nbytes = []
    pending = None
    for i in range(2):
        b = [torch.from_numpy(z[f"{k}{i}"]) for k in ("h", "r", "t", "neg")]
        nb, nn = len(b[0]) // world, len(b[3]) // world
        mine = [x[rank * nb:(rank + 1) * nb] for x in b[:3]]
        mine.append(b[3][rank * nn:(rank + 1) * nn])
        comm.reset_counters()
        if case["deferred"]:
            _, pending, _ = model.train_step_async(state, pending, *mine,
                                                   None, neg_head=i == 0)
        else:
            model.train_step(state, *mine, None, neg_head=i == 0)
        nbytes.append(comm.bytes)
    model.flush_async(state, pending)
    sizes[name] = nbytes
    out = state_to_numpy(state)
    arrays = {"ent": out.entity.emb, "ent_ss": out.entity.state_sum,
              "rel": out.relation.emb, "rel_ss": out.relation.state_sum,
              "step": np.asarray(out.step)}
    if out.projection is not None:
        arrays.update(proj=out.projection.emb,
                      proj_ss=out.projection.state_sum)
    np.savez(f"{root}/{name}.rank{rank}.npz", **arrays)
    if rank == 0 and case["single"]:
        # the port's own single-device step on the global batch
        one = KEModel(cfg, n_ent, n_rel, device="cpu")
        st = full()
        pending = None
        for i in range(2):
            b = [torch.from_numpy(z[f"{k}{i}"])
                 for k in ("h", "r", "t", "neg")]
            if case["deferred"]:
                _, pending, _ = one.train_step_async(st, pending, *b, None,
                                                     neg_head=i == 0)
            else:
                one.train_step(st, *b, None, neg_head=i == 0)
        one.flush_async(st, pending)
        o = state_to_numpy(st)
        np.savez(f"{root}/{name}.single.npz", ent=o.entity.emb,
                 ent_ss=o.entity.state_sum, rel=o.relation.emb,
                 rel_ss=o.relation.state_sum)
print("RESULT " + json.dumps({"bytes": sizes, "backend": comm.backend}))
comm.close()
"""


def _cfg(family):
    return dict(BASE, model_name=family, **FAMILIES[family])


def _tables(family, n_ent, seed=0):
    """Random numpy tables at the family's widths (state_sum nonzero)."""
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.models.ke_model import KEModel
    m = KEModel(KGEConfig(**_cfg(family)), n_ent, N_REL, device="cpu")
    rng = np.random.default_rng(seed)

    def tab(n, d):
        return ((rng.standard_normal((n, d)) * 0.3).astype(np.float32),
                np.abs(rng.standard_normal(n)).astype(np.float32))

    out = {}
    for key, n, d in (("ent", n_ent, m.entity_dim),
                      ("rel", N_REL, m.relation_dim)):
        out[key], out[key + "_ss"] = tab(n, d)
    if m.is_transr:
        out["proj"], out["proj_ss"] = tab(N_REL, m.proj_dim)
    return out


def _batches(seed=1):
    """Two global batches of W*B rows and W*B negatives; ids repeat (a few
    hot entities) and all lie below 43."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(2):
        out[f"h{i}"] = rng.integers(0, 12, W * B).astype(np.int32)
        out[f"t{i}"] = rng.integers(0, 12, W * B).astype(np.int32)
        out[f"r{i}"] = rng.integers(0, N_REL, W * B).astype(np.int32)
        neg = rng.integers(0, N_ENT, W * B).astype(np.int32)
        neg[:2] = out[f"h{i}"][:2]
        out[f"neg{i}"] = neg
    return out


def _cases():
    cases = [dict(name=f"{f}-{p}", family=f, plan=p, n_ent=N_ENT,
                  single=True, deferred=False) for f in FAMILIES for p in PLANS]
    cases += [dict(name=f"TransE_l2-{p}-big", family="TransE_l2", plan=p,
                   n_ent=BIG, single=False, deferred=False) for p in PLANS]
    cases += [dict(name=f"{f}-{p}-async", family=f, plan=p, n_ent=N_ENT,
                   single=True, deferred=True)
              for f in ("TransE_l2", "RESCAL") for p in PLANS]
    return cases


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_step"))
    cases = _cases()
    batches = _batches()
    for c in cases:
        c["cfg"] = _cfg(c["family"])
        np.savez(f"{root}/{c['name']}.npz",
                 **_tables(c["family"], c["n_ent"]), **batches)
    with open(f"{root}/cases.json", "w") as f:
        json.dump(cases, f)
    res = results(run_ranks(lambda r: ["-c", _WORKER, root], W))
    return root, {c["name"]: c for c in cases}, res


def _load(root, name, who):
    return dict(np.load(f"{root}/{name}.{who}.npz"))


def _jax_step(case, root):
    """The JAX package's two steps of the case on a 2-device mesh."""
    z = np.load(f"{root}/{case['name']}.npz")
    cfg = JaxConfig(**case["cfg"])
    model = JaxModel(cfg, case["n_ent"], N_REL)

    def tab(k):
        return JaxTable(jnp.asarray(z[k]), jnp.asarray(z[k + "_ss"]))

    state = JaxState(tab("ent"), tab("rel"),
                     tab("proj") if "proj" in z else None,
                     jnp.asarray(3, jnp.int32))
    plan = JaxPlan(make_mesh(W), table_sharding=case["plan"])
    state = plan.put_state(jax.device_get(state))
    for i in range(2):
        batch = plan.put_batch({k: z[f"{k}{i}"]
                                for k in ("h", "r", "t", "neg")})
        step = jax.jit(lambda st, h, r, t, neg, nh=(i == 0):
                       model.train_step(st, h, r, t, neg, None,
                                        neg_head=nh))
        state, _ = step(state, batch["h"], batch["r"], batch["t"],
                        batch["neg"])
    return jax.device_get(state)


def _close(got, want, family):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL[family])


def _port_tables(root, case):
    """The 2-rank result as whole tables: the entity shards concatenated
    and unpadded (vocab), rank 0's replicas otherwise."""
    r0, r1 = (_load(root, case["name"], f"rank{r}") for r in range(W))
    out = dict(r0)
    if case["plan"] == "vocab":
        for k in ("ent", "ent_ss"):
            out[k] = np.concatenate([r0[k], r1[k]])[:case["n_ent"]]
    return out, r0, r1


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_two_rank_step_matches_jax_mesh_step(run, family, plan):
    root, cases, _ = run
    case = cases[f"{family}-{plan}"]
    got, _, _ = _port_tables(root, case)
    want = _jax_step(case, root)
    assert int(got["step"]) == int(want.step) == 5
    pairs = [("ent", want.entity), ("rel", want.relation)]
    if family == "TransR":
        pairs.append(("proj", want.projection))
    for key, w in pairs:
        _close(got[key], np.asarray(w.emb)[:case["n_ent"]
                                           if key == "ent" else None],
               family)
        _close(got[key + "_ss"],
               np.asarray(w.state_sum)[:case["n_ent"] if key == "ent"
                                       else None], family)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_two_rank_step_matches_single_device_step(run, family, plan):
    root, cases, _ = run
    case = cases[f"{family}-{plan}"]
    got, _, _ = _port_tables(root, case)
    one = _load(root, case["name"], "single")
    for key in ("ent", "ent_ss", "rel", "rel_ss"):
        _close(got[key], one[key], family)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("family", ["TransE_l2", "RESCAL"])
def test_two_rank_async_steps_match_single_device(run, family, plan):
    root, cases, _ = run
    case = cases[f"{family}-{plan}-async"]
    got, r0, r1 = _port_tables(root, case)
    one = _load(root, case["name"], "single")
    sync = _load(root, f"{family}-{plan}", "single")
    for key in ("ent", "ent_ss", "rel", "rel_ss"):
        _close(got[key], one[key], family)
    for key in ("rel", "rel_ss"):
        np.testing.assert_array_equal(r0[key], r1[key])
    # the deferred update is a different trajectory from the synchronous
    assert not np.allclose(one["ent"], sync["ent"])


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_replicated_tables_are_bit_identical_across_ranks(run, family,
                                                          plan):
    root, cases, _ = run
    case = cases[f"{family}-{plan}"]
    _, r0, r1 = _port_tables(root, case)
    keys = ["rel", "rel_ss"] + (["proj", "proj_ss"] if family == "TransR"
                                else [])
    if plan == "replicated":
        keys += ["ent", "ent_ss"]
    else:
        # the shards: rank 1's last row is padding, never touched
        per = -(-N_ENT // W)
        assert r0["ent"].shape == r1["ent"].shape == (per, DIM)
        assert not r1["ent"][N_ENT - per:].any()
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def _expected_bytes(plan):
    """Per step, summed over the ranks.  Each collective counts the bytes
    handed to it and returned by it on each rank.  n_e = 2B + B ids a
    rank (int32), De = Dr = 16 fp32 columns."""
    n_e, de, dr = 3 * B, DIM, DIM
    # relations, both plans: all-gathered ids [B] and rows [B, Dr]
    rel = W * (1 + W) * (4 * B + 4 * B * dr)
    if plan == "replicated":
        return W * (1 + W) * (4 * n_e + 4 * n_e * de) + rel
    # vocab, the fixed-capacity route: W blocks of n_e slots handed over
    # and received each way, no counts; ids out, rows back, gradient rows
    # out
    return W * (2 * 4 * W * n_e + 4 * 4 * W * n_e * de) + rel


@pytest.mark.parametrize("plan", PLANS)
def test_collective_bytes_per_step_are_batch_proportional(run, plan):
    _, _, res = run
    for step in range(2):
        small = sum(r["bytes"][f"TransE_l2-{plan}"][step] for r in res)
        big = sum(r["bytes"][f"TransE_l2-{plan}-big"][step] for r in res)
        assert small == big == _expected_bytes(plan), (small, big)
    # and far below the table
    assert _expected_bytes(plan) < BIG * DIM * 4 * W


def test_ranks_run_on_gloo_on_the_cpu(run):
    _, _, res = run
    assert [r["backend"] for r in res] == ["gloo"] * W
