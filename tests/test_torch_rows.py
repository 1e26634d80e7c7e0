"""dglke_tpu_torch row kernels' CPU path against the JAX package.

On the CPU every wrapper in dglke_tpu_torch.ops.rows takes its plain
PyTorch version; these tests hold that version to the Pallas kernels of
dglke_tpu/ops/pallas/rows.py (run in interpret mode, as
tests/test_pallas_rows.py runs them) and to dglke_tpu.ops.embedding.
The CUDA kernels themselves are held to the same plain versions on the
card by chip_smoke.py.

Tolerances: the gather moves bits, so it is exact.  The updates sum in
another order than XLA: fp32 tables within rtol 1e-5 / atol 1e-6.  A bf16
table's touched rows are summed in fp32 and rounded once by the port, so
they lie within one bf16 ulp (plus atol 1e-6, for fp32 sums that cancel
near zero) of the exact update rounded once.  The JAX package rounds each
occurrence's delta and add to bf16, so against it a touched element may
differ by one bf16 ulp for each of those roundings (occurrences + 1) at
the magnitude |row| + sum |delta|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dglke_tpu.ops import embedding as jax_emb
from dglke_tpu.ops.pallas import rows as jax_rows
from dglke_tpu_torch.ops import embedding as pt_emb
from dglke_tpu_torch.ops import rows as pt_rows

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def to_torch(arr) -> torch.Tensor:
    """A numpy (or JAX host) array as a CPU tensor; bf16 keeps its bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def max_bf16_ulps(got, want) -> float:
    """Largest |got - want| in units of (one bf16 ulp of want + atol)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(want), 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float(np.max(np.abs(got - want) / (ulp + ATOL)))


def bf16_rounded_once(emb0, ids, delta) -> np.ndarray:
    """The exact per-occurrence row add, rounded once to bf16."""
    exact = np.asarray(emb0, np.float64).copy()
    np.add.at(exact, ids, np.asarray(delta, np.float64))
    return np.asarray(jnp.asarray(exact.astype(np.float32), jnp.bfloat16),
                      np.float32)


def within_jax_bf16_roundings(got, want, emb0, ids, delta) -> bool:
    """|got - want| <= (occurrences + 1) bf16 ulps at |emb0| + sum |delta|,
    plus atol, for every element."""
    emb0 = np.asarray(emb0, np.float32)
    occ = np.bincount(ids, minlength=emb0.shape[0])[:, None]
    mag = np.abs(emb0)
    np.add.at(mag, ids, np.abs(delta))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    return bool(np.all(diff <= (occ + 1) * ulp + ATOL))


def _table(rng, num, dim, dtype):
    t = (rng.standard_normal((num, dim)) * 0.1).astype(np.float32)
    return np.asarray(jnp.asarray(t, dtype=dtype))


# -- K1: gather ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width,dim", [(64, 64), (48, 40)])
def test_gather_rows_matches_pallas_and_jax(dtype, width, dim):
    rng = np.random.default_rng(0)
    table = _table(rng, 300, width, jnp.dtype(dtype))
    ids = rng.integers(0, 300, size=120).astype(np.int32)
    got = pt_rows.gather_rows(to_torch(table), torch.from_numpy(ids), dim)
    assert got.dtype == torch.float32 and got.shape == (120, dim)

    pallas = np.asarray(jax_rows.gather_rows(
        jnp.asarray(table), jnp.asarray(ids), interpret=True))
    np.testing.assert_array_equal(
        got.numpy(), pallas[:, :dim].astype(np.float32))
    state = jax_emb.EmbeddingState(jnp.asarray(table),
                                   jnp.zeros((300,), jnp.float32))
    ref = np.asarray(jax_emb.gather_rows(state, jnp.asarray(ids),
                                         dtype=jnp.float32, dim=dim))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_gather_rows_checks_arguments():
    table = torch.zeros((10, 8))
    with pytest.raises(ValueError):
        pt_rows.gather_rows(table, torch.zeros(3, dtype=torch.int32), 9)
    with pytest.raises(TypeError):
        pt_rows.gather_rows(table.double(), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        pt_rows.gather_rows(table, torch.zeros((3, 1), dtype=torch.int32))


@pytest.mark.parametrize("dim", [1, 91, 400, 1024, 250_000, 1_000_000])
def test_gather_shape_by_width(dim):
    """One warp per narrow row (the flagship's 400 among them), blocks over
    (row, chunk) per wide row (RESCAL's 250,000 among them)."""
    shape = pt_rows.gather_shape(dim)
    assert shape in pt_rows.GATHER_SHAPES
    assert shape == ("wide" if dim >= pt_rows.GATHER_WIDE_MIN else "warp")
    if dim <= 400:
        assert shape == "warp"
    if dim >= 250_000:
        assert shape == "wide"


@pytest.mark.parametrize("shape", ["tile", "wide_loads"])
def test_gather_rows_refuses_an_unknown_shape(shape):
    """A shape K1 does not have, among them the mapped tables' earlier one
    (blocks over (row, chunk) with the threads' own loads), which lost to
    the line-window shape on the card and was taken out."""
    table = torch.zeros((10, 8))
    with pytest.raises(ValueError, match="shape"):
        pt_rows.launch_gather(table, torch.zeros(3, dtype=torch.int32), 8,
                              shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_at_a_wide_ragged_width_matches_pallas(dtype):
    """A width above the wide threshold, not a multiple of 4 or of the
    chunk, with a narrower dim: exact against the Pallas kernel."""
    rng = np.random.default_rng(8)
    width = pt_rows.GATHER_WIDE_MIN + 4099
    table = _table(rng, 12, width, jnp.dtype(dtype))
    ids = rng.integers(0, 12, size=9).astype(np.int32)
    dim = width - 2
    assert pt_rows.gather_shape(dim) == "wide" and dim % 4 != 0
    got = pt_rows.gather_rows(to_torch(table), torch.from_numpy(ids), dim)
    pallas = np.asarray(jax_rows.gather_rows(
        jnp.asarray(table), jnp.asarray(ids), interpret=True))
    np.testing.assert_array_equal(got.numpy(),
                                  pallas[:, :dim].astype(np.float32))


# -- K2: scatter_add_rows -----------------------------------------------------


def _scatter_cases():
    r = np.random.default_rng(2)
    yield "no_duplicates", (r.standard_normal((300, 64)).astype(np.float32),
                            r.permutation(300)[:100].astype(np.int32),
                            r.standard_normal((100, 64)).astype(np.float32))
    r = np.random.default_rng(3)
    yield "heavy_duplicates", (
        r.standard_normal((10, 32)).astype(np.float32),
        r.integers(0, 10, size=200).astype(np.int32),
        r.standard_normal((200, 32)).astype(np.float32))
    yield "adjacent_duplicates", (
        np.zeros((4, 32), np.float32),
        np.array([2, 2, 2, 1, 1, 2], np.int32),
        np.arange(6 * 32, dtype=np.float32).reshape(6, 32))


SCATTER = dict(_scatter_cases())


@pytest.mark.parametrize("case", list(SCATTER))
def test_scatter_add_rows_matches_pallas(case):
    table, ids, delta = SCATTER[case]
    got = to_torch(table)
    pt_rows.scatter_add_rows(got, torch.from_numpy(ids),
                             torch.from_numpy(delta))
    want = np.asarray(jax_rows.scatter_add_rows(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(delta),
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    exact = table.copy()
    np.add.at(exact, ids, delta)
    np.testing.assert_allclose(got.numpy(), exact, rtol=RTOL, atol=ATOL)


def test_scatter_add_rows_bf16_matches_pallas():
    rng = np.random.default_rng(4)
    table = _table(rng, 40, 32, jnp.bfloat16)
    ids = rng.integers(0, 40, size=120).astype(np.int32)
    delta = (rng.standard_normal((120, 32)) * 0.01).astype(np.float32)
    got = to_torch(table)
    pt_rows.scatter_add_rows(got, torch.from_numpy(ids),
                             torch.from_numpy(delta))
    want = jax_rows.scatter_add_rows(jnp.asarray(table), jnp.asarray(ids),
                                     jnp.asarray(delta), interpret=True)
    got = to_numpy(got)
    assert max_bf16_ulps(got, bf16_rounded_once(table, ids, delta)) <= 1.0
    assert within_jax_bf16_roundings(got, want, table, ids, delta)


# -- K2: sparse_adagrad_update ---------------------------------------------


# (rows, ids drawn from the first `hot` rows): <= 2048 rows is the JAX
# package's dense one-hot arm, more rows its scatter arm.
TABLES = {"relation_sized": (60, 60), "entity_sized": (3000, 150)}


def _adagrad_inputs(seed, rows, hot, dtype, n=400, dim=32):
    rng = np.random.default_rng(seed)
    emb = _table(rng, rows, dim, jnp.dtype(dtype))
    state = np.abs(rng.standard_normal(rows)).astype(np.float32)
    ids = rng.integers(0, hot, size=n).astype(np.int32)
    grads = rng.standard_normal((n, dim)).astype(np.float32)
    return emb, state, ids, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", list(TABLES))
def test_sparse_adagrad_update_matches_jax(size, dtype):
    emb, state, ids, grads = _adagrad_inputs(5, *TABLES[size], dtype)
    lr = 0.25
    table = pt_emb.EmbeddingState(to_torch(emb), to_torch(state))
    out = pt_emb.sparse_adagrad_update(table, torch.from_numpy(ids),
                                       torch.from_numpy(grads), lr)
    assert out is table     # in place
    want = jax_emb.sparse_adagrad_update(
        jax_emb.EmbeddingState(jnp.asarray(emb), jnp.asarray(state)),
        jnp.asarray(ids), jnp.asarray(grads), lr)
    assert table.emb.dtype == to_torch(emb).dtype
    assert table.state_sum.dtype == torch.float32
    np.testing.assert_allclose(table.state_sum.numpy(),
                               np.asarray(want.state_sum), rtol=RTOL,
                               atol=ATOL)
    got_emb = to_numpy(table.emb)
    want_emb = np.asarray(want.emb, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got_emb, want_emb, rtol=RTOL, atol=ATOL)
    else:
        std = np.sqrt(table.state_sum.numpy()[ids]) + 1e-10
        delta = -lr * grads / std[:, None]
        assert max_bf16_ulps(got_emb, bf16_rounded_once(emb, ids,
                                                        delta)) <= 1.0
        assert within_jax_bf16_roundings(got_emb, want_emb, emb, ids, delta)
    untouched = np.setdiff1d(np.arange(emb.shape[0]), ids)
    np.testing.assert_array_equal(got_emb[untouched],
                                  np.asarray(emb, np.float32)[untouched])


@pytest.mark.parametrize("size", list(TABLES))
def test_sparse_adagrad_update_matches_segment_dedup(size):
    """The per-occurrence update equals a deduplicated update built on
    segment_dedup (the documented equivalence of ops/embedding.py)."""
    emb, state, ids, grads = _adagrad_inputs(6, *TABLES[size], "float32")
    lr = 0.1
    table = pt_emb.EmbeddingState(to_torch(emb), to_torch(state))
    pt_emb.sparse_adagrad_update(table, torch.from_numpy(ids),
                                 torch.from_numpy(grads), lr)

    uids, ugrads, usq = pt_emb.segment_dedup(torch.from_numpy(ids),
                                             torch.from_numpy(grads))
    n_unique = len(np.unique(ids))
    uids, ugrads, usq = (x[:n_unique].numpy() for x in (uids, ugrads, usq))
    want_state = state.copy()
    want_state[uids] += usq
    want_emb = emb.copy()
    want_emb[uids] += -lr * ugrads / (np.sqrt(want_state[uids]) + 1e-10)[:,
                                                                         None]
    np.testing.assert_allclose(table.state_sum.numpy(), want_state,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(table.emb.numpy(), want_emb, rtol=RTOL,
                               atol=ATOL)


def test_segment_dedup_matches_jax():
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 20, size=64).astype(np.int32)
    grads = rng.standard_normal((64, 8)).astype(np.float32)
    got = pt_emb.segment_dedup(torch.from_numpy(ids),
                               torch.from_numpy(grads))
    want = jax_emb.segment_dedup(jnp.asarray(ids), jnp.asarray(grads))
    n_unique = len(np.unique(ids))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    assert not got[1][n_unique:].any() and not got[2][n_unique:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_embedding(dtype):
    def make(seed):
        gen = torch.Generator("cpu")
        gen.manual_seed(seed)
        return pt_emb.init_embedding(gen, 50, 16, 0.5, dtype, device="cpu")

    a, b = make(3), make(3)
    assert a.emb.shape == (50, 16) and a.emb.dtype == dtype
    assert a.state_sum.dtype == torch.float32
    assert not a.state_sum.any()
    assert float(a.emb.float().abs().max()) <= 0.5
    assert torch.equal(a.emb, b.emb)
    assert not torch.equal(a.emb, make(4).emb)


def test_cpu_path_counts_no_launches():
    pt_rows.reset_launches()
    table = torch.zeros((10, 8))
    ids = torch.tensor([1, 1, 3], dtype=torch.int32)
    pt_rows.gather_rows(table, ids)
    pt_rows.sparse_adagrad_rows(table, torch.zeros(10), ids,
                                torch.ones((3, 8)), 0.1)
    pt_rows.scatter_add_rows(table, ids, torch.ones((3, 8)))
    assert all(v == 0 for v in pt_rows.launches.values())
