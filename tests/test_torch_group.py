"""The id grouping and K2's planners, and K2's CPU path on long segments,
against the JAX package.

On the CPU, rows.group_ids takes its plain version (the stable torch.sort
and the segments from its head flags) at every batch size, and K2's
wrappers take theirs; these
tests hold them to numpy's stable argsort, to the JAX package's stable
argsort and to the JAX package's K2 (the Pallas kernel in interpret mode,
as tests/test_pallas_rows.py runs it, and ops/embedding.py).  The planners
are plain Python: what they choose here is what the card is given.  The
CUDA kernels are held to the same plain versions on the card by
chip_smoke.py.

Tolerances as in tests/test_torch_rows.py: fp32 within rtol 1e-5 / atol
1e-6; a bf16 table within one bf16 ulp of the exact update rounded once,
and within one ulp per JAX rounding of the JAX package.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dglke_tpu.ops import embedding as jax_emb
from dglke_tpu.ops.pallas import rows as jax_rows
from dglke_tpu_torch.ops import embedding as pt_emb
from dglke_tpu_torch.ops import rows as pt_rows

from test_torch_rows import (RTOL, ATOL, bf16_rounded_once, max_bf16_ulps,
                             to_numpy, to_torch, within_jax_bf16_roundings)

torch.set_num_threads(2)

FREEBASE_ROWS = 86_054_151


# -- planners ------------------------------------------------------------------


@pytest.mark.parametrize("n_rows", [1, 2, 1345, 14951, 1 << 14, (1 << 14) + 1,
                                    FREEBASE_ROWS, 1 << 31])
@pytest.mark.parametrize("n", [0, 1, 33, 1000, 3000, pt_rows.GROUP_BLOCK_MAX,
                               pt_rows.GROUP_BLOCK_MAX + 1, 12_288, 24_000,
                               1 << 20])
def test_plan_group(n, n_rows):
    """The bits cover n_rows - 1 and no more; the one-block kernel takes
    every batch up to its limit, with the fewest ids a thread that cover
    it; the tiles route takes the rest, in tiles of the one-block limit
    merged pairwise: 2 tiles in 1 pass at 8,193 and 12,288 ids, 3 in 2 at
    24,000, 128 in 7 at 2^20."""
    plan = pt_rows.plan_group(n, n_rows)
    assert plan.bits >= 1 and (1 << plan.bits) >= n_rows
    assert plan.bits == 1 or (1 << (plan.bits - 1)) < n_rows
    if n > pt_rows.GROUP_BLOCK_MAX:
        tiles, passes = {pt_rows.GROUP_BLOCK_MAX + 1: (2, 1), 12_288: (2, 1),
                         24_000: (3, 2), 1 << 20: (128, 7)}[n]
        assert plan == pt_rows.GroupPlan("tiles", plan.bits, tiles=tiles,
                                         passes=passes)
        assert (plan.tiles - 1) * pt_rows.GROUP_BLOCK_MAX < n
        assert plan.tiles * pt_rows.GROUP_BLOCK_MAX >= n
        assert 1 << (plan.passes - 1) < plan.tiles <= 1 << plan.passes
        assert plan.kernels == 4 + passes
        return
    assert plan.route == "block" and plan.kernels == 1
    assert plan.items in pt_rows.GROUP_ITEMS
    assert plan.items * pt_rows.GROUP_THREADS >= n
    smaller = [k for k in pt_rows.GROUP_ITEMS if k < plan.items]
    assert all(k * pt_rows.GROUP_THREADS < n for k in smaller)


def test_plan_group_at_the_main_paths():
    """The flagship's entity and relation batches take the kernel: 14 and
    11 bits, 12 and 4 ids a thread."""
    assert pt_rows.plan_group(3000, 14951) == pt_rows.GroupPlan("block", 14,
                                                                12)
    assert pt_rows.plan_group(1000, 1345) == pt_rows.GroupPlan("block", 11, 4)
    assert pt_rows.plan_group(3000, FREEBASE_ROWS).bits == 27


@pytest.mark.parametrize("n,n_rows", [(-1, 10), (5, 0), (5, (1 << 31) + 1),
                                      (1 << 31, 10)])
def test_plan_group_refuses(n, n_rows):
    with pytest.raises(ValueError):
        pt_rows.plan_group(n, n_rows)


@pytest.mark.parametrize("dim,route,lane_vecs", [
    (16, "warp", 1), (400, "warp", 4), (500, "warp", 4), (1024, "warp", 8),
    (1025, "block", 0), (160_000, "block", 0)])
def test_plan_update_by_width(dim, route, lane_vecs):
    """One warp per segment while a warp's lanes hold the row in up to 8
    vectors of four elements each (the flagship's 400 and RESCAL's 500
    among them); one block per segment above (TransR's 160,000-wide
    projection rows)."""
    plan = pt_rows.plan_update(dim)
    assert plan == pt_rows.UpdatePlan(route, lane_vecs)
    if route == "warp":
        assert 128 * plan.lane_vecs >= dim
        assert plan.lane_vecs == 1 or 64 * plan.lane_vecs < dim


def test_plan_update_refuses_an_empty_row():
    with pytest.raises(ValueError):
        pt_rows.plan_update(0)


# -- refusals --------------------------------------------------------------------


def _k2_calls(ids):
    table = torch.zeros((10, 8))
    grads = torch.ones((3, 8))
    return {
        "sparse_adagrad_rows": lambda: pt_rows.sparse_adagrad_rows(
            table, torch.zeros(10), ids, grads, 0.1),
        "scatter_add_rows": lambda: pt_rows.scatter_add_rows(table, ids,
                                                             grads),
        "group_ids": lambda: pt_rows.group_ids(ids, 10),
    }


@pytest.mark.parametrize("call", ["sparse_adagrad_rows", "scatter_add_rows",
                                  "group_ids"])
@pytest.mark.parametrize("ids", [
    torch.zeros(3, dtype=torch.float32), torch.zeros(3, dtype=torch.int16),
    torch.zeros((3, 1), dtype=torch.int32)], ids=["float", "int16", "2d"])
def test_refuses_ids_of_the_wrong_kind(call, ids):
    with pytest.raises(TypeError):
        _k2_calls(ids)[call]()


@pytest.mark.parametrize("call", ["sparse_adagrad_rows", "scatter_add_rows"])
def test_refuses_ids_on_another_device(call):
    ids = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="ids on meta"):
        _k2_calls(ids)[call]()


# -- the grouping ----------------------------------------------------------------


def _grouping_cases():
    r = np.random.default_rng(11)
    yield "flagship entity", r.integers(0, 14951, 3000), 14951
    yield "flagship relation", r.integers(0, 1345, 1000), 1345
    yield "all equal", np.full(500, 7), 10
    yield "permuted arange", r.permutation(700), 700
    yield "one id", np.array([3]), 10
    yield "33 ids", r.integers(0, 5, 33), 5
    yield "Freebase id range", r.integers(0, FREEBASE_ROWS, 400), FREEBASE_ROWS
    yield "no ids", np.zeros(0), 4


GROUPINGS = {k: (ids, n_rows) for k, ids, n_rows in _grouping_cases()}


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", list(GROUPINGS))
def test_group_ids_matches_a_stable_argsort(case, dtype):
    """sids and order are the stable sort's; the segments list each
    distinct id once, in order, at the position of its first occurrence;
    the JAX package's stable argsort gives the same order."""
    ids, n_rows = GROUPINGS[case]
    g = pt_rows.group_ids(torch.from_numpy(ids).to(dtype), n_rows)
    want = np.argsort(ids, kind="stable")
    assert g.sids.dtype == torch.int32 and g.order.dtype == torch.int64
    np.testing.assert_array_equal(g.order.numpy(), want)
    np.testing.assert_array_equal(g.sids.numpy(), ids[want])
    if len(ids):
        np.testing.assert_array_equal(
            g.order.numpy(), np.asarray(jnp.argsort(jnp.asarray(ids),
                                                    stable=True)))
    uniq, first, counts = np.unique(ids, return_index=True,
                                    return_counts=True)
    c = int(g.count)
    assert c == len(uniq)
    heads = g.heads[:c + 1].numpy()
    np.testing.assert_array_equal(heads, np.concatenate(
        [[0], np.cumsum(counts)]).astype(np.int32))
    np.testing.assert_array_equal(g.seg_ids[:c].numpy(), uniq)
    np.testing.assert_array_equal(g.seg_first[:c].numpy(), first)


def test_group_ids_tiles_route_counts_no_launch_on_the_cpu():
    """CPU ids of the tiles route's size take the plain grouping."""
    pt_rows.reset_launches()
    ids = torch.zeros(pt_rows.GROUP_BLOCK_MAX + 1, dtype=torch.int32)
    assert pt_rows.plan_group(ids.numel(), 3).route == "tiles"
    assert int(pt_rows.group_ids(ids, 3).count) == 1
    assert all(v == 0 for v in pt_rows.launches.values())


def test_group_scratch_slots():
    """Two runs of (id, position) pairs and a head count a segment block."""
    n = 24_000
    assert pt_rows.group_scratch_slots(n) == 4 * n + 12
    assert pt_rows.group_scratch_slots(2048) == 4 * 2048 + 1


def _long_segment_batch(n, seed):
    """n ids over 10,000 rows with long segments: 30% one id, 10% another,
    runs of one id longer than a 2,048-rank block, the rest uniform."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 10_000, n)
    ids[:3 * n // 10] = 17
    ids[3 * n // 10:4 * n // 10] = 9_999
    ids = rng.permutation(ids)
    ids[5_000:7_500] = 0          # a run of one id across a block edge
    return ids, 10_000


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [12_288, 24_000])
def test_group_ids_plain_above_the_block_limit(n, dtype):
    """The yardstick of the tiles route on the card: the plain grouping of
    a batch above the one-block limit, with long segments, is numpy's
    stable argsort and the segments numpy's unique finds."""
    ids, n_rows = _long_segment_batch(n, seed=n)
    assert pt_rows.plan_group(n, n_rows).route == "tiles"
    g = pt_rows.group_ids_plain(torch.from_numpy(ids).to(dtype))
    want = np.argsort(ids, kind="stable")
    np.testing.assert_array_equal(g.order.numpy(), want)
    np.testing.assert_array_equal(g.sids.numpy(), ids[want].astype(np.int32))
    uniq, first, counts = np.unique(ids, return_index=True,
                                    return_counts=True)
    c = int(g.count)
    assert c == len(uniq) and counts.max() > pt_rows.GROUP_SEG_IDS
    np.testing.assert_array_equal(g.heads[:c + 1].numpy(), np.concatenate(
        [[0], np.cumsum(counts)]).astype(np.int32))
    np.testing.assert_array_equal(g.seg_ids[:c].numpy(), uniq)
    np.testing.assert_array_equal(g.seg_first[:c].numpy(), first)


# -- K2 on long segments, against the JAX package --------------------------------


def _long_segment_ids(case, rows, n, rng):
    if case == "all equal":
        return np.full(n, rows // 2)
    if case == "one id 40%":
        ids = rng.integers(0, rows, n)
        ids[:2 * n // 5] = 3
        return rng.permutation(ids)
    if case == "all distinct":
        return rng.permutation(rows)[:n]
    # "ids 0 and rows - 1": the two ends of the range, among others
    ids = rng.integers(0, rows, n)
    ids[::4], ids[1::4] = 0, rows - 1
    return ids


LONG = ["all equal", "one id 40%", "all distinct", "ids 0 and rows - 1"]
# (rows, ids): <= 2048 rows is the JAX package's dense one-hot arm, more
# rows its scatter arm.
SIZES = {"relation_sized": (400, 300), "entity_sized": (3000, 400)}


def _long_inputs(case, size, dtype, seed):
    rows, n = SIZES[size]
    rng = np.random.default_rng(seed)
    ids = _long_segment_ids(case, rows, n, rng).astype(np.int32)
    emb = np.asarray(jnp.asarray(
        (rng.standard_normal((rows, 16)) * 0.1).astype(np.float32),
        jnp.dtype(dtype)))
    state = np.abs(rng.standard_normal(rows)).astype(np.float32)
    grads = rng.standard_normal((n, 16)).astype(np.float32)
    return emb, state, ids, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("case", LONG)
def test_sparse_adagrad_long_segments_match_jax(case, size, dtype):
    emb, state, ids, grads = _long_inputs(case, size, dtype, 21)
    lr = 0.25
    table = pt_emb.EmbeddingState(to_torch(emb), to_torch(state))
    pt_emb.sparse_adagrad_update(table, torch.from_numpy(ids),
                                 torch.from_numpy(grads), lr)
    want = jax_emb.sparse_adagrad_update(
        jax_emb.EmbeddingState(jnp.asarray(emb), jnp.asarray(state)),
        jnp.asarray(ids), jnp.asarray(grads), lr)
    np.testing.assert_allclose(table.state_sum.numpy(),
                               np.asarray(want.state_sum), rtol=RTOL,
                               atol=ATOL)
    got = to_numpy(table.emb)
    want_emb = np.asarray(want.emb, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want_emb, rtol=RTOL, atol=ATOL)
    else:
        std = np.sqrt(table.state_sum.numpy()[ids]) + 1e-10
        delta = -lr * grads / std[:, None]
        assert max_bf16_ulps(got, bf16_rounded_once(emb, ids, delta)) <= 1.0
        assert within_jax_bf16_roundings(got, want_emb, emb, ids, delta)
    untouched = np.setdiff1d(np.arange(emb.shape[0]), ids)
    np.testing.assert_array_equal(got[untouched],
                                  np.asarray(emb, np.float32)[untouched])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", LONG)
def test_scatter_add_rows_long_segments_match_pallas(case, dtype):
    emb, _, ids, grads = _long_inputs(case, "relation_sized", dtype, 22)
    delta = grads * np.float32(0.01)
    got = to_torch(emb)
    pt_rows.scatter_add_rows(got, torch.from_numpy(ids),
                             torch.from_numpy(delta))
    want = np.asarray(jax_rows.scatter_add_rows(
        jnp.asarray(emb), jnp.asarray(ids), jnp.asarray(delta),
        interpret=True), np.float32)
    got = to_numpy(got)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        exact = emb.astype(np.float64)
        np.add.at(exact, ids, delta.astype(np.float64))
        np.testing.assert_allclose(got, exact, rtol=RTOL, atol=ATOL)
    else:
        assert max_bf16_ulps(got, bf16_rounded_once(emb, ids, delta)) <= 1.0
        assert within_jax_bf16_roundings(got, want, emb, ids, delta)
