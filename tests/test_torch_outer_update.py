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
    outer_adagrad_plain,
    outer_adagrad_update,
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
