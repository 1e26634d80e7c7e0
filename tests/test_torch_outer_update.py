"""dglke_tpu_torch's outer-product Adagrad (RESCAL's relation update) against
the JAX package: the port's plain version against the JAX kernel in
interpret mode and against JAX's sparse_adagrad_update on the materialized
gradient, from the same numpy inputs.

Tolerance: rtol 1e-5 / atol 1e-6 on tables and Adagrad state (fp32 on
both sides; the JAX kernel subtracts per occurrence, the plain version
adds per occurrence through index_add_, in other orders).  Rows no id
touches stay bit-equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dglke_tpu.ops.embedding import EmbeddingState as JaxTable
from dglke_tpu.ops.embedding import sparse_adagrad_update as jax_sparse
from dglke_tpu.ops.pallas.outer_update import (
    outer_adagrad_update as jax_outer,
)
from dglke_tpu_torch.ops import rows
from dglke_tpu_torch.ops.embedding import EmbeddingState
from dglke_tpu_torch.ops.outer_update import (
    CLUSTER_SIZES,
    SLICE_MAX,
    SLICE_TARGET,
    SMEM_MAX,
    outer_adagrad_plain,
    outer_adagrad_update,
    plan_outer,
)

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
E, DA, DB, N, LR = 17, 8, 12, 25, 0.3


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((E, DA * DB)).astype(np.float32)
    ss = np.abs(rng.standard_normal(E)).astype(np.float32)
    ids = rng.integers(0, E - 3, N).astype(np.int32)  # duplicates; 3 untouched
    a = rng.standard_normal((N, DA)).astype(np.float32)
    b = rng.standard_normal((N, DB)).astype(np.float32)
    return emb, ss, ids, a, b


def _port(emb, ss, ids, a, b, coef, norm):
    table = EmbeddingState(torch.from_numpy(emb.copy()),
                           torch.from_numpy(ss.copy()))
    out = outer_adagrad_update(table, torch.from_numpy(ids),
                               torch.from_numpy(a), torch.from_numpy(b), LR,
                               reg_coef=coef, reg_norm=norm)
    assert out is table           # in place
    return table.emb.numpy(), table.state_sum.numpy()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


REG = [(2e-3, 3), (2e-3, 2), (0.0, 3)]
REG_IDS = ["norm3", "norm2", "coef0"]


@pytest.mark.parametrize("coef,norm", REG, ids=REG_IDS)
def test_matches_the_jax_kernel_in_interpret_mode(coef, norm):
    emb, ss, ids, a, b = _inputs()
    want = jax_outer(JaxTable(jnp.asarray(emb), jnp.asarray(ss)),
                     jnp.asarray(ids), jnp.asarray(a), jnp.asarray(b), LR,
                     reg_coef=coef, reg_norm=norm, interpret=True)
    got_emb, got_ss = _port(emb, ss, ids, a, b, coef, norm)
    _close(got_emb, want.emb)
    _close(got_ss, want.state_sum)
    untouched = np.setdiff1d(np.arange(E), ids)
    assert untouched.size >= 3
    np.testing.assert_array_equal(got_emb[untouched], emb[untouched])
    np.testing.assert_array_equal(got_ss[untouched], ss[untouched])


@pytest.mark.parametrize("coef,norm", REG, ids=REG_IDS)
def test_matches_jax_sparse_adagrad_on_the_materialized_gradient(coef, norm):
    emb, ss, ids, a, b = _inputs(seed=1)
    g = np.einsum("bi,bj->bij", a, b).reshape(N, -1)
    if coef:
        r = emb[ids]
        g = g + coef * norm * np.abs(r) ** (norm - 1) * np.sign(r)
    want = jax_sparse(JaxTable(jnp.asarray(emb), jnp.asarray(ss)),
                      jnp.asarray(ids), jnp.asarray(g), LR)
    got_emb, got_ss = _port(emb, ss, ids, a, b, coef, norm)
    _close(got_emb, want.emb)
    _close(got_ss, want.state_sum)


def test_plain_version_equals_the_wrapper_on_the_cpu():
    emb, ss, ids, a, b = _inputs(seed=2)
    e, s = torch.from_numpy(emb.copy()), torch.from_numpy(ss.copy())
    outer_adagrad_plain(e, s, torch.from_numpy(ids), torch.from_numpy(a),
                        torch.from_numpy(b), LR, 2e-3, 3)
    got_emb, got_ss = _port(emb, ss, ids, a, b, 2e-3, 3)
    np.testing.assert_array_equal(got_emb, e.numpy())
    np.testing.assert_array_equal(got_ss, s.numpy())


def test_refuses_a_bf16_table_and_counts_no_launch_on_the_cpu():
    emb, ss, ids, a, b = _inputs()
    rows.reset_launches()
    _port(emb, ss, ids, a, b, 2e-3, 3)
    assert rows.launches["outer_adagrad_update"] == 0
    table = EmbeddingState(torch.from_numpy(emb).to(torch.bfloat16),
                           torch.from_numpy(ss))
    with pytest.raises(TypeError, match="float32"):
        outer_adagrad_update(table, torch.from_numpy(ids),
                             torch.from_numpy(a), torch.from_numpy(b), LR)
    assert rows.launches["outer_adagrad_update"] == 0


@pytest.mark.parametrize("what", ["width", "rows", "ids"])
def test_refuses_mismatched_factors(what):
    emb, ss, ids, a, b = _inputs()
    table = EmbeddingState(torch.from_numpy(emb), torch.from_numpy(ss))
    ta, tb, tid = (torch.from_numpy(x) for x in (a, b, ids))
    if what == "width":
        tb = tb[:, :-1]
    elif what == "rows":
        ta = ta[:-1]
    else:
        tid = tid.float()
    with pytest.raises((ValueError, TypeError)):
        outer_adagrad_update(table, tid, ta, tb, LR)


# -- the route planner (the C side launches what it is given) -----------------

WIDTHS = [(1, 1), (7, 13), (32, 32), (500, 500), (1000, 1000)]


@pytest.mark.parametrize("da,db", WIDTHS,
                         ids=[f"{da}x{db}" for da, db in WIDTHS])
def test_plan_outer_covers_the_row_in_aligned_slices(da, db):
    plan = plan_outer(da, db)
    width = da * db
    if plan.route == "tiles":
        # wider than 16 slices of SLICE_MAX bytes
        assert 4 * -(-width // 16) > SLICE_MAX
        return
    assert plan.route == "cluster" and plan.cluster in CLUSTER_SIZES
    assert plan.slice % 4 == 0                       # 16-byte aligned slices
    assert plan.cluster * plan.slice >= width        # full coverage
    assert (plan.cluster - 1) * plan.slice < width   # every CTA has work
    assert 4 * plan.slice <= SLICE_MAX
    # the smallest size whose slices fit the target, when one does
    smaller = [c for c in CLUSTER_SIZES if c < plan.cluster]
    assert all(4 * -(-width // c) > SLICE_TARGET for c in smaller)
    # every CTA's span of a-rows fits the staging rows
    for rank in range(plan.cluster):
        e0 = rank * plan.slice
        e1 = min(width, e0 + plan.slice)
        assert (e1 - 1) // db - e0 // db + 1 <= plan.span <= da
    assert plan.smem_bytes == 4 * (plan.slice
                                   + plan.stage_occ * (plan.span + db))
    assert plan.smem_bytes <= SMEM_MAX


def test_plan_outer_at_rescal_widths():
    # hidden 500: 16 CTAs of 62.5 KB (two share an SM); hidden 32: one CTA;
    # hidden 1,000: wider than a cluster holds, the tiles route.
    plan = plan_outer(500, 500)
    assert (plan.route, plan.cluster, plan.slice) == ("cluster", 16, 15628)
    assert plan.stage_occ >= 8
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    assert plan_outer(32, 32) == plan_outer(32, 32, cluster=1)
    assert plan_outer(32, 32).cluster == 1
    assert plan_outer(1000, 1000).route == "tiles"
    assert plan_outer(500, 500, cluster=8).slice == 31252


@pytest.mark.parametrize("da,db,cluster", [(1000, 1000, 16), (32, 32, 3),
                                           (500, 500, 4)])
def test_plan_outer_refuses_a_cluster_that_cannot_hold_the_row(da, db,
                                                               cluster):
    with pytest.raises(ValueError):
        plan_outer(da, db, cluster=cluster)


def test_ragged_width_with_a_long_segment_matches_the_jax_kernel():
    """Da 7 x Db 13 (91 elements, not a multiple of 4) and one id repeated
    6 times: the plain version against the JAX kernel in interpret mode."""
    rng = np.random.default_rng(3)
    e, da, db, n = 11, 7, 13, 20
    emb = rng.standard_normal((e, da * db)).astype(np.float32)
    ss = np.abs(rng.standard_normal(e)).astype(np.float32)
    ids = np.concatenate([np.full(6, 4), rng.integers(0, e - 2, n - 6)])
    ids = rng.permutation(ids).astype(np.int32)
    assert np.bincount(ids).max() >= 6
    a = rng.standard_normal((n, da)).astype(np.float32)
    b = rng.standard_normal((n, db)).astype(np.float32)
    want = jax_outer(JaxTable(jnp.asarray(emb), jnp.asarray(ss)),
                     jnp.asarray(ids), jnp.asarray(a), jnp.asarray(b), LR,
                     reg_coef=2e-3, reg_norm=3, interpret=True)
    got_emb, got_ss = _port(emb, ss, ids, a, b, 2e-3, 3)
    _close(got_emb, want.emb)
    _close(got_ss, want.state_sum)
    untouched = np.setdiff1d(np.arange(e), ids)
    np.testing.assert_array_equal(got_emb[untouched], emb[untouched])
