"""K1 with RESCAL's matrix-vector product (ops/rows.py:gather_rows_matvec):
each gathered relation row, a [hidden, hidden] matrix R, times its edge's
entity vector, R t on head-corrupt steps and h^T R on tail-corrupt ones:

  * the route: K1 forms the product only for an fp32 table on the card
    whose square rows take the wide shape and the bulk copy, hidden up to
    MATVEC_MAX_HIDDEN, fp32 vectors and p in 0, 1, 2, 3; every other table
    takes the gather (with the sum), then the PyTorch product;
  * on the CPU the rows, the sum and the product are gather_rows',
    pow_sum_plain's and torch.bmm's to the bit, and no launch is counted;
  * RESCAL's factored step scores with the product the gather gives;
  * on a card (the ``card`` marker; skipped without one): the product
    within 1e-6 of an fp64 product over table[ids] (relative to the sum of
    its terms' magnitudes) in both directions at hidden 500 and at hidden
    46 (rows of 184 bytes, off 16-byte boundaries), repeated ids, p = 0,
    1, 2, 3; hidden 47 (rows not a multiple of four) on the PyTorch route
    to the same tolerance; the rows byte-identical to the plain K1 launch
    and the fused sum within 1e-6 of fp64's; two calls and two replays of a
    captured CUDA graph bit-identical; one count a launch.

This file imports nothing of JAX, so that its card tests run on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_rows_matvec.py -m card
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.models import ke_model
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.ops import rows

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _table(n_rows, dim, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    t = torch.empty((n_rows, dim)).uniform_(-0.052, 0.052, generator=gen)
    return t.to(device)


def _ids(n, n_rows, seed=1, device="cpu"):
    ids = np.random.default_rng(seed).integers(0, n_rows, n).astype(np.int32)
    return torch.from_numpy(ids).to(device)


def _stand_in(dtype=torch.float32, pitch=250_000, address=1 << 20,
              device="cuda"):
    """What fused_matvec reads of a table, without a card."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           stride=lambda i: pitch, data_ptr=lambda: address)


def _vecs(n=5, hidden=500, dtype=torch.float32, col_stride=1,
          device="cuda"):
    """What fused_matvec reads of the vectors."""
    return SimpleNamespace(shape=(n, hidden), dtype=dtype,
                           device=torch.device(device), dim=lambda: 2,
                           stride=lambda i: hidden if i == 0 else col_stride)


# ---------------------------------------------------------------------------
# The route


@pytest.mark.parametrize("p", [0, 1, 2, 3])
@pytest.mark.parametrize("hidden", [46, 500, rows.MATVEC_MAX_HIDDEN])
def test_card_tables_of_square_wide_fp32_rows_take_the_fused_product(
        p, hidden):
    dim = hidden * hidden
    assert rows.fused_matvec(_stand_in(pitch=dim), torch.zeros(5),
                             _vecs(hidden=hidden), dim, p)


@pytest.mark.parametrize("case", [
    dict(table=dict(device="cpu")),                 # a CPU (or mapped) table
    dict(table=dict(dtype=torch.bfloat16)),
    dict(table=dict(address=(1 << 20) + 8)),
    dict(table=dict(pitch=250_002)),
    dict(hidden=44),                                # the warp shape
    dict(hidden=47),                                # 2,209: not a multiple of 4
    dict(hidden=rows.MATVEC_MAX_HIDDEN + 2),
    dict(dim=250_000 - 4),                          # not square
    dict(vecs=dict(dtype=torch.bfloat16)),
    dict(vecs=dict(col_stride=2)),
    dict(vecs=dict(device="cpu")),
    dict(vecs=dict(n=4)),
    dict(p=4),
    dict(n=0),
])
def test_every_other_table_takes_the_plain_product(case):
    hidden = case.get("hidden", 500)
    dim = case.get("dim", hidden * hidden)
    n = case.get("n", 5)
    table = _stand_in(**{"pitch": dim, **case.get("table", {})})
    vecs = _vecs(**{"n": n, "hidden": hidden, **case.get("vecs", {})})
    assert not rows.fused_matvec(table, torch.zeros(n), vecs, dim,
                                 case.get("p", 3))


@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("hidden", [46, 47, 64, 100, 500, 1000,
                                    rows.MATVEC_MAX_HIDDEN])
def test_stages_and_bands_fit_the_kernel(hidden, head):
    stage, band = rows.matvec_rows(hidden, head)
    assert (stage * hidden) % 4 == 0
    assert 0 < stage * hidden <= rows.MATVEC_STAGE
    assert band % stage == 0 and -(-hidden // band) <= 65535
    if hidden == 500:
        assert (stage, band) == ((4, 8) if head else (4, 96))


# ---------------------------------------------------------------------------
# The plain route, on the CPU


def _bmm(rel_rows, vecs, head):
    """The factored step's product as it formed it before the gather did."""
    n, hidden = vecs.shape
    rmat = rel_rows.reshape(n, hidden, hidden)
    if head:
        return torch.bmm(rmat, vecs[:, :, None])[:, :, 0]
    return torch.bmm(vecs[:, None, :], rmat)[:, 0, :]


@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("p", [0, 1, 2, 3])
def test_cpu_route_is_the_gather_the_sum_and_bmm(head, p):
    hidden = 7
    table = _table(30, hidden * hidden)
    ids = _ids(64, 30)                   # repeated ids
    vecs = _table(64, hidden, seed=2)
    before = dict(rows.launches)
    got, total, tmp = rows.gather_rows_matvec(table, ids, vecs, head, p)
    assert rows.launches == before
    want = rows.gather_rows(table, ids)
    assert torch.equal(got, want)
    assert torch.equal(tmp, _bmm(want, vecs, head))
    if p == 0:
        assert total is None
    else:
        assert torch.equal(total, rows.pow_sum_plain(want, p))


def test_cpu_route_takes_the_first_dim_columns():
    table = _table(10, 30)                 # rows wider than 5 x 5
    ids = _ids(8, 10)
    vecs = _table(8, 5, seed=3)
    got, _, tmp = rows.gather_rows_matvec(table, ids, vecs, False, 2, dim=25)
    assert torch.equal(got, table[ids.long(), :25])
    assert torch.equal(tmp, _bmm(got, vecs, False))


def test_no_ids_give_no_rows():
    got, total, tmp = rows.gather_rows_matvec(
        _table(5, 16), torch.zeros(0, dtype=torch.int32),
        torch.zeros((0, 4)), True, 2)
    assert got.shape == (0, 16) and tmp.shape == (0, 4)
    assert float(total) == 0.0


# ---------------------------------------------------------------------------
# The step


def _cfg(**over):
    kw = dict(model_name="RESCAL", hidden_dim=8, gamma=12.0, lr=0.1,
              batch_size=16, neg_sample_size=4, max_step=10,
              neg_adversarial_sampling=True, regularization_coef=2e-3,
              regularization_norm=3, seed=3)
    kw.update(over)
    return KGEConfig(**kw)


def _batch(n_ent, n_rel, b, n_neg, seed=4, device="cpu"):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, n, size).astype(np.int32)).to(
        device) for n, size in ((n_ent, b), (n_rel, b), (n_ent, b),
                                (n_ent, n_neg))]


@pytest.mark.parametrize("neg_head", [True, False])
def test_factored_step_scores_with_the_gathers_product(monkeypatch,
                                                       neg_head):
    """The step takes tmp from the gather and forms no product of its own:
    with the gather's product replaced by zeros every score is 0."""
    real = ke_model.gather_rows_matvec
    seen = []

    def zero_product(table, ids, vecs, head, p, dim=None):
        seen.append((head, vecs.shape))
        got, total, tmp = real(table, ids, vecs, head, p, dim)
        return got, total, torch.zeros_like(tmp)

    monkeypatch.setattr(ke_model, "gather_rows_matvec", zero_product)
    cfg = _cfg(regularization_coef=0.0)
    model = KEModel(cfg, 40, 5, device="cpu")
    h, r, t, neg = _batch(40, 5, 16, 16)
    loss, log, _ = model.loss_and_grads(model.init_state(), h, r, t, neg,
                                        None, neg_head=neg_head)
    assert seen == [(neg_head, (16, model.entity_dim))]
    want, _ = model.loss_gen.get_total_loss(
        torch.zeros(16), torch.zeros((16, cfg.neg_sample_size)), None)
    assert torch.equal(loss, want)


@pytest.mark.parametrize("neg_head", [True, False])
def test_factored_step_gives_its_vectors_in_the_orientation(monkeypatch,
                                                             neg_head):
    """R t takes the tails' rows, h^T R the heads'."""
    real = ke_model.gather_rows_matvec
    seen = []

    def spy(table, ids, vecs, head, p, dim=None):
        seen.append(vecs.clone())
        return real(table, ids, vecs, head, p, dim)

    monkeypatch.setattr(ke_model, "gather_rows_matvec", spy)
    model = KEModel(_cfg(), 40, 5, device="cpu")
    state = model.init_state()
    h, r, t, neg = _batch(40, 5, 16, 16)
    model.loss_and_grads(state, h, r, t, neg, None, neg_head=neg_head)
    side = t if neg_head else h
    assert torch.equal(seen[0], state.entity.emb[side.long()])


# ---------------------------------------------------------------------------
# On the card


CARD_ROWS = 1000
CARD_TABLE = 300


def _fp64_product(table, ids, vecs, head):
    """The product in fp64 and the sum of its terms' magnitudes."""
    mats = table[ids.long()].double()
    v = vecs.double()
    return _bmm(mats, v, head), _bmm(mats.abs(), v.abs(), head)


def _hold_product(tmp, table, ids, vecs, head):
    want, scale = _fp64_product(table, ids, vecs, head)
    assert tmp.dtype == torch.float32 and tmp.shape == want.shape
    gap = (tmp.double() - want).abs()
    assert bool((gap <= 1e-6 * scale).all()), float((gap / scale).max())


@pytest.mark.card
@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("p", [0, 1, 2, 3])
@pytest.mark.parametrize("hidden", [500, 46, 47])
def test_fused_product_on_the_card(card, hidden, p, head):
    dim = hidden * hidden
    table = _table(CARD_TABLE, dim, device=card)
    ids = _ids(CARD_ROWS, CARD_TABLE, device=card)
    assert len(set(ids.tolist())) < CARD_ROWS      # repeated ids
    vecs = _table(CARD_ROWS, hidden, seed=5, device=card)
    fused = rows.fused_matvec(table, ids, vecs, dim, p)
    assert fused == (hidden != 47)
    before = dict(rows.launches)
    got, total, tmp = rows.gather_rows_matvec(table, ids, vecs, head, p)
    again, total2, tmp2 = rows.gather_rows_matvec(table, ids, vecs, head, p)
    torch.cuda.synchronize(card)
    counted = {k: rows.launches[k] - before[k] for k in before}
    assert counted["gather_rows_matvec"] == (2 if fused else 0)
    assert counted["gather_rows"] == 2
    assert counted["gather_rows_pow_sum"] == (2 if p and fused else 0)
    _hold_product(tmp, table, ids, vecs, head)
    assert torch.equal(tmp.view(torch.int32), tmp2.view(torch.int32))
    plain = rows.launch_gather(table, ids, dim, "wide")
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    assert torch.equal(again.view(torch.int32), plain.view(torch.int32))
    if p == 0:
        assert total is None and total2 is None
    elif fused:
        want = float(torch.sum(torch.abs(table[ids.long()].double()) ** p))
        assert abs(float(total) - want) <= 1e-6 * want
        assert torch.equal(total.view(torch.int32), total2.view(torch.int32))
    else:
        assert torch.equal(total, rows.pow_sum_plain(plain, p))


@pytest.mark.card
@pytest.mark.parametrize("head", [True, False])
def test_fused_product_replays_give_the_same_bits(card, head):
    hidden = 500
    table = _table(CARD_TABLE, hidden * hidden, device=card)
    ids = _ids(CARD_ROWS, CARD_TABLE, device=card)
    vecs = _table(CARD_ROWS, hidden, seed=5, device=card)
    eager = rows.gather_rows_matvec(table, ids, vecs, head, 3)
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(stream):
        rows.gather_rows_matvec(table, ids, vecs, head, 3)   # warm
    torch.cuda.current_stream(card).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = rows.gather_rows_matvec(table, ids, vecs, head, 3)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize(card)
        for g, e in zip(captured, eager):
            assert torch.equal(g.view(torch.int32), e.view(torch.int32))
