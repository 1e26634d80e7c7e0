"""Eval over a vocab-sharded entity table on 2 ranks (gloo, the CPU): the
filtered full-entity ranks (KEModel.eval_ranks_sharded: the positive side
through the routed gather, each rank scoring its own rows, one
all-reduce of the counts) are identical to the JAX package's
make_sharded_eval_superstep on a 2-device mesh and to one device's ranks,
on 43 entities (one shard padded), with the default candidate block and
with blocks of 8 rows (several blocks a shard and a re-covered tail
block); the sampled ranks through the routed gather are identical to the
JAX package's and to one device's.  Ranks are compared as integers.
TransE_l2 (the matmul form) and TransR (the broadcast form, projection
rows).  Candidate-list eval (wikikg90M's protocol) under both plans: the
Valid metrics of every rank equal one device's (float64 partial sums
added over the strides of replicated tables), and the test_{rank}.pkl
files, taken in stride order, hold one device's top-10."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.models.ke_model import KEModel as JaxModel
from dglke_tpu.models.ke_model import TrainState as JaxState
from dglke_tpu.ops.embedding import EmbeddingState as JaxTable
from dglke_tpu.parallel.mesh import ShardingPlan as JaxPlan
from dglke_tpu.parallel.mesh import make_mesh
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import synthetic_dataset
from dglke_tpu_torch.data.sampler import FilterIndex
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.utils.convert import (
    NumpyState,
    NumpyTable,
    state_from_numpy,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_util import results, run_ranks  # noqa: E402

torch.set_num_threads(2)

W, N_ENT, N_REL, DIM, B, K = 2, 43, 5, 16, 12, 9
FAMILIES = {"TransE_l2": dict(gamma=4.0), "TransR": dict(gamma=4.0)}

_WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.parallel.mesh import ShardingPlan, init_distributed
from dglke_tpu_torch.trainer import CandidateEvalSampler, evaluate_candidates
from dglke_tpu_torch.utils.convert import (NumpyState, NumpyTable,
                                           state_from_numpy)

root = sys.argv[1]
comm = init_distributed("cpu")
out = {}
for family, cfgd in json.load(open(f"{root}/families.json")).items():
    z = np.load(f"{root}/{family}.npz")
    full = state_from_numpy(NumpyState(
        NumpyTable(z["ent"], z["ent_ss"]), NumpyTable(z["rel"], z["rel_ss"]),
        np.asarray(0, np.int32),
        NumpyTable(z["proj"], z["proj_ss"]) if "proj" in z else None),
        device="cpu")
    plan = ShardingPlan(comm, "vocab", int(z["ent"].shape[0]))
    model = KEModel(KGEConfig(**cfgd), plan.n_entities, z["rel"].shape[0],
                    plan=plan)
    state = plan.shard_state(full)
    t = {k: torch.from_numpy(z[k]) for k in z.files}
    res = {}
    for mode in ("head", "tail"):
        nh = mode == "head"
        fid, fm = t[f"fid_{mode}"], t[f"fm_{mode}"]
        res[f"full_{mode}"] = model.eval_ranks(
            state, t["h"], t["r"], t["t"], fid, fm, neg_head=nh).tolist()
        res[f"block8_{mode}"] = model.eval_ranks_sharded(
            state, t["h"], t["r"], t["t"], fid, fm, neg_head=nh,
            block=8).tolist()
        res[f"sampled_{mode}"] = model.eval_ranks_sampled(
            state, t["h"], t["r"], t["t"], t["neg"], t[f"keep_{mode}"],
            neg_head=nh).tolist()
    edges = {"h,r->t": {"hr": z["cand_hr"], "t_candidate": z["cand_t"],
                        "t_correct_index": z["cand_ans"]}}
    for ts in ("vocab", "replicated"):
        plan = ShardingPlan(comm, ts, int(z["ent"].shape[0]))
        model = KEModel(KGEConfig(**cfgd), plan.n_entities,
                        z["rel"].shape[0], plan=plan)
        state = plan.shard_state(full)
        strided = (comm.rank, comm.world) if ts == "replicated" else (0, 1)
        sampler = CandidateEvalSampler(edges, 5, *strided)
        res[f"cand_{ts}"] = evaluate_candidates(
            model, state, sampler, "Valid", log=lambda *a: None, plan=plan)
        evaluate_candidates(model, state, sampler, "Test",
                            save_path=f"{root}/{family}-{ts}", plan=plan)
    out[family] = res
print("RESULT " + json.dumps(out))
comm.close()
"""


def _cfg(family):
    return dict(model_name=family, hidden_dim=DIM, **FAMILIES[family])


def _inputs(family):
    """Random tables, a test batch with its filter lists (both modes), a
    sampled-negative draw with its keep masks."""
    ds = synthetic_dataset(n_entities=N_ENT, n_relations=N_REL,
                           n_train=400, n_valid=10, n_test=B, seed=4)
    fi = FilterIndex(ds)
    m = KEModel(KGEConfig(**_cfg(family)), N_ENT, N_REL, device="cpu")
    rng = np.random.default_rng(2)
    z = {}
    for key, n, d in (("ent", N_ENT, m.entity_dim),
                      ("rel", N_REL, m.relation_dim),
                      ("proj", N_REL, m.proj_dim if m.is_transr else 0)):
        if d:
            z[key] = (rng.standard_normal((n, d)) * 0.3).astype(np.float32)
            z[key + "_ss"] = np.zeros(n, np.float32)
    h, r, t = (np.asarray(x, np.int32) for x in ds.test)
    z.update(h=h, r=r, t=t,
             neg=rng.integers(0, N_ENT, K).astype(np.int32))
    for mode in ("head", "tail"):
        z[f"fid_{mode}"], z[f"fm_{mode}"] = fi.padded_lists(mode, h, r, t)
        z[f"keep_{mode}"] = fi.false_neg_mask(mode, h, r, t, z["neg"])
    # 23 candidate queries (an odd count: the strides differ) of 11
    # candidates each, some listed twice
    z["cand_hr"] = np.stack([rng.integers(0, N_ENT, 23),
                             rng.integers(0, N_REL, 23)], 1).astype(np.int32)
    z["cand_t"] = rng.integers(0, N_ENT, (23, 11)).astype(np.int32)
    z["cand_t"][:, 10] = z["cand_t"][:, 3]
    z["cand_ans"] = rng.integers(0, 11, 23).astype(np.int32)
    return z


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_eval"))
    inputs = {f: _inputs(f) for f in FAMILIES}
    for f, z in inputs.items():
        np.savez(f"{root}/{f}.npz", **z)
        for ts in ("vocab", "replicated"):
            os.makedirs(f"{root}/{f}-{ts}")
    with open(f"{root}/families.json", "w") as fh:
        json.dump({f: _cfg(f) for f in FAMILIES}, fh)
    res = results(run_ranks(lambda r: ["-c", _WORKER, root], W))
    return inputs, res, root


def _jax(family, z):
    model = JaxModel(JaxConfig(**_cfg(family)), N_ENT, N_REL)

    def tab(k):
        return (JaxTable(jnp.asarray(z[k]), jnp.asarray(z[k + "_ss"]))
                if k in z else None)

    state = JaxState(tab("ent"), tab("rel"), tab("proj"),
                     jnp.asarray(0, jnp.int32))
    plan = JaxPlan(make_mesh(W), table_sharding="vocab")
    sharded = plan.put_state(jax.device_get(state))
    step = model.make_sharded_eval_superstep(plan)
    sampled = jax.jit(model.eval_ranks_sampled,
                      static_argnames=("neg_head",))
    out = {}
    for mode in ("head", "tail"):
        nh = mode == "head"
        out[f"full_{mode}"] = np.asarray(step(
            sharded, z["h"][None], z["r"][None], z["t"][None],
            z[f"fid_{mode}"][None], z[f"fm_{mode}"][None],
            neg_head=nh))[0]
        out[f"sampled_{mode}"] = np.asarray(sampled(
            sharded, z["h"], z["r"], z["t"], z["neg"], z[f"keep_{mode}"],
            neg_head=nh))
    return out


def _single(family, z):
    model = KEModel(KGEConfig(**_cfg(family)), N_ENT, N_REL, device="cpu")
    state = state_from_numpy(NumpyState(
        NumpyTable(z["ent"], z["ent_ss"]), NumpyTable(z["rel"], z["rel_ss"]),
        np.asarray(0, np.int32),
        NumpyTable(z["proj"], z["proj_ss"]) if "proj" in z else None),
        device="cpu")
    t = {k: torch.from_numpy(v) for k, v in z.items()}
    out = {}
    for mode in ("head", "tail"):
        nh = mode == "head"
        out[f"full_{mode}"] = model.eval_ranks(
            state, t["h"], t["r"], t["t"], t[f"fid_{mode}"],
            t[f"fm_{mode}"], neg_head=nh).numpy()
        out[f"sampled_{mode}"] = model.eval_ranks_sampled(
            state, t["h"], t["r"], t["t"], t["neg"], t[f"keep_{mode}"],
            neg_head=nh).numpy()
    return out


@pytest.mark.parametrize("mode", ["head", "tail"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_filtered_ranks_match_jax_and_one_device(run, family, mode):
    inputs, res, _ = run
    want_jax = _jax(family, inputs[family])[f"full_{mode}"]
    want_one = _single(family, inputs[family])[f"full_{mode}"]
    np.testing.assert_array_equal(want_jax, want_one)
    for rank in range(W):
        got = res[rank][family]
        np.testing.assert_array_equal(got[f"full_{mode}"], want_one)
        np.testing.assert_array_equal(got[f"block8_{mode}"], want_one)
    # the filter lists hold more than the true entity somewhere
    assert inputs[family][f"fm_{mode}"].sum(1).max() > 1


@pytest.mark.parametrize("mode", ["head", "tail"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_sampled_ranks_match_jax_and_one_device(run, family, mode):
    inputs, res, _ = run
    want_jax = _jax(family, inputs[family])[f"sampled_{mode}"]
    want_one = _single(family, inputs[family])[f"sampled_{mode}"]
    np.testing.assert_array_equal(want_jax, want_one)
    for rank in range(W):
        np.testing.assert_array_equal(res[rank][family][f"sampled_{mode}"],
                                      want_one)


@pytest.mark.parametrize("plan", ["vocab", "replicated"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_candidate_eval_under_a_plan_matches_one_device(run, family, plan,
                                                        tmp_path):
    import pickle
    from dglke_tpu_torch.trainer import (
        CandidateEvalSampler,
        evaluate_candidates,
    )
    inputs, res, root = run
    z = inputs[family]
    model = KEModel(KGEConfig(**_cfg(family)), N_ENT, N_REL, device="cpu")
    state = state_from_numpy(NumpyState(
        NumpyTable(z["ent"], z["ent_ss"]), NumpyTable(z["rel"], z["rel_ss"]),
        np.asarray(0, np.int32),
        NumpyTable(z["proj"], z["proj_ss"]) if "proj" in z else None),
        device="cpu")
    sampler = CandidateEvalSampler({"h,r->t": {
        "hr": z["cand_hr"], "t_candidate": z["cand_t"],
        "t_correct_index": z["cand_ans"]}}, 5)
    want = evaluate_candidates(model, state, sampler, "Valid",
                               log=lambda *a: None)
    evaluate_candidates(model, state, sampler, "Test",
                        save_path=str(tmp_path))
    with open(tmp_path / "test_0.pkl", "rb") as f:
        one = pickle.load(f)["h,r->t"]
    for rank in range(W):
        got = res[rank][family][f"cand_{plan}"]
        assert set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) < 1e-12, (k, got, want)
    parts = []
    for rank in range(W):
        with open(f"{root}/{family}-{plan}/test_{rank}.pkl", "rb") as f:
            parts.append(pickle.load(f)["h,r->t"])
    for key in ("t_pred_top10", "t_correct_index"):
        merged = np.empty_like(one[key])
        for rank, part in enumerate(parts):
            merged[rank::W] = part[key]
        np.testing.assert_array_equal(merged, one[key])
