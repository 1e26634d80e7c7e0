"""The port's 2-rank step at a batch whose owner update groups more ids
than the one-block grouping holds, against its own single-device step on
the global batch.

WN18's DistMult recipe shape (examples/wn18.sh:15-17: batch 2,048 and 128
negatives a rank, 40,943 entities, 18 relations) at dim 16: a rank gathers
3 x 2,048 entity ids a step, so under the vocab plan each owner receives
2 x 6,144 = 12,288 slots, and under the replicated plan each replica
updates the 12,288 all-gathered ids; on a card that grouping takes the
tiles route (ops/rows.py:plan_group).  On the CPU the grouping is the
plain one at any size: this holds the routing at that size.  The JAX
package has no --dist step at this size to compare with.

Tolerance: fp32 rtol 1e-5 / atol 1e-6 (the summation orders differ).
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_util import results, run_ranks  # noqa: E402

W = 2
N_ENT, N_REL, DIM, B, NEG = 40_943, 18, 16, 2048, 128
CFG = dict(model_name="DistMult", hidden_dim=DIM, gamma=20.0, lr=0.14,
           batch_size=B, neg_sample_size=NEG, neg_adversarial_sampling=True,
           regularization_coef=1e-6)
PLANS = ("vocab", "replicated")

_WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.ops import rows
from dglke_tpu_torch.parallel.mesh import ShardingPlan, init_distributed
from dglke_tpu_torch.utils.convert import (NumpyState, NumpyTable,
                                           state_from_numpy, state_to_numpy)

root = sys.argv[1]
comm = init_distributed("cpu")
rank, world = comm.rank, comm.world
spec = json.load(open(f"{root}/spec.json"))
z = np.load(f"{root}/inputs.npz")
cfg = KGEConfig(**spec["cfg"])
n_ent, n_rel = z["ent"].shape[0], z["rel"].shape[0]

def full():
    def tab(k):
        return NumpyTable(z[k], z[k + "_ss"])
    return state_from_numpy(NumpyState(tab("ent"), tab("rel"),
                                       np.asarray(3, np.int32), None),
                            device="cpu")

batch = [torch.from_numpy(z[k]) for k in ("h", "r", "t", "neg")]
nb, nn = len(batch[0]) // world, len(batch[3]) // world
mine = [x[rank * nb:(rank + 1) * nb] for x in batch[:3]]
mine.append(batch[3][rank * nn:(rank + 1) * nn])
# the id counts each plan's updates group, and the route a card takes
update = rows.sparse_adagrad_rows
seen = []
def counted(emb, state_sum, ids, grads, lr):
    seen.append([int(ids.shape[0]),
                 rows.plan_group(ids.shape[0], emb.shape[0]).route])
    return update(emb, state_sum, ids, grads, lr)
rows.sparse_adagrad_rows = counted
grouped = {}
for ts in spec["plans"]:
    plan = ShardingPlan(comm, ts, n_ent)
    model = KEModel(cfg, n_ent, n_rel, plan=plan)
    state = plan.shard_state(full())
    seen.clear()
    model.train_step(state, *mine, None, neg_head=True)
    grouped[ts] = list(seen)
    out = state_to_numpy(state)
    np.savez(f"{root}/{ts}.rank{rank}.npz", ent=out.entity.emb,
             ent_ss=out.entity.state_sum, rel=out.relation.emb,
             rel_ss=out.relation.state_sum)
rows.sparse_adagrad_rows = update
if rank == 0:
    one = KEModel(cfg, n_ent, n_rel, device="cpu")
    st = full()
    one.train_step(st, *batch, None, neg_head=True)
    o = state_to_numpy(st)
    np.savez(f"{root}/single.npz", ent=o.entity.emb,
             ent_ss=o.entity.state_sum, rel=o.relation.emb,
             rel_ss=o.relation.state_sum)
print("RESULT " + json.dumps({"grouped": grouped, "backend": comm.backend}))
comm.close()
"""


def _inputs(seed=0):
    """Tables (state_sum nonzero) and one global batch of W*B rows and W*B
    negatives; a few hot entities repeat across the ranks' slices."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, n in (("ent", N_ENT), ("rel", N_REL)):
        out[key] = (rng.standard_normal((n, DIM)) * 0.3).astype(np.float32)
        out[key + "_ss"] = np.abs(rng.standard_normal(n)).astype(np.float32)
    for key in ("h", "t", "neg"):
        ids = rng.integers(0, N_ENT, W * B)
        ids[::50] = 7
        out[key] = ids.astype(np.int32)
    out["r"] = rng.integers(0, N_REL, W * B).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_wide"))
    np.savez(f"{root}/inputs.npz", **_inputs())
    with open(f"{root}/spec.json", "w") as f:
        json.dump({"cfg": CFG, "plans": PLANS}, f)
    res = results(run_ranks(lambda r: ["-c", _WORKER, root], W))
    return root, res


def _tables(root, plan):
    """The 2-rank result as whole tables: the entity shards concatenated
    and unpadded (vocab), rank 0's replicas otherwise."""
    r0, r1 = (dict(np.load(f"{root}/{plan}.rank{r}.npz")) for r in range(W))
    if plan == "vocab":
        for k in ("ent", "ent_ss"):
            r0[k] = np.concatenate([r0[k], r1[k]])[:N_ENT]
    return r0


@pytest.mark.parametrize("plan", PLANS)
def test_two_rank_step_above_the_block_limit_matches_one_device(run, plan):
    root, _ = run
    got = _tables(root, plan)
    one = dict(np.load(f"{root}/single.npz"))
    for key in ("ent", "ent_ss", "rel", "rel_ss"):
        np.testing.assert_allclose(got[key], one[key], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("plan", PLANS)
def test_each_owner_groups_12288_ids_on_the_tiles_route(run, plan):
    """Every rank's entity update groups n x N = 12,288 ids (the tiles
    route on a card), its relation update 2 x 2,048 (one block)."""
    _, res = run
    for r in res:
        assert r["backend"] == "gloo"
        assert sorted(map(tuple, r["grouped"][plan])) == [
            (W * B, "block"), (W * 3 * B, "tiles")]
