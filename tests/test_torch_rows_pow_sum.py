"""K1 with the sum of |x|^p (ops/rows.py:gather_rows_pow_sum), the
regularization value of RESCAL's relation rows:

  * the route: K1's wide bulk copy sums the rows only for an fp32 table on
    the card with aligned wide rows and p in 1, 2, 3; every other table
    takes the plain gather and the PyTorch sum;
  * on the CPU (a CPU table, rows under GATHER_WIDE_MIN among them) the
    rows are gather_rows' and the sum is models/loss.py:regularization's
    to the bit, and no launch is counted;
  * RESCAL's factored step takes the relation rows' value from its
    relation gather (gather_rows_matvec, which sums through it, and with
    p = 0 without regularization); TransE never calls it;
  * on a card (the ``card`` marker; skipped without one): the fused sum
    within 1e-6 of an fp64 sum over table[ids] at widths 2,048, 4,100 and
    250,000 (122 chunks and a tail of 144), repeated ids, p = 1, 2, 3; the
    rows byte-identical to the plain K1 launch; two calls and two replays
    of a captured CUDA graph bit-identical; one count a launch; RESCAL's
    factored step's regularization within 1e-6 of the three-pass value, one
    fused launch (with the product, tests/test_torch_rows_matvec.py) and
    its tables within the step parity's tolerance of the CPU's.

This file imports nothing of JAX, so that its card tests run on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_rows_pow_sum.py -m card
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.models import ke_model
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.models.loss import regularization
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


def _stand_in(dtype=torch.float32, pitch=2048, address=1 << 20,
              device="cuda"):
    """What fused_pow_sum reads of a table, without a card."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           stride=lambda i: pitch,
                           data_ptr=lambda: address)


# ---------------------------------------------------------------------------
# The route


@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("dim", [rows.GATHER_WIDE_MIN, 4100, 250_000])
def test_card_tables_of_aligned_wide_fp32_rows_take_the_fused_sum(p, dim):
    assert rows.fused_pow_sum(_stand_in(pitch=dim), torch.zeros(3), dim, p)


@pytest.mark.parametrize("case", [
    dict(device="cpu"),                             # a CPU (or mapped) table
    dict(dtype=torch.bfloat16),
    dict(dim=rows.GATHER_WIDE_MIN - 4),             # the warp shape
    dict(dim=4098),                                 # not a multiple of 4
    dict(pitch=4098),
    dict(address=(1 << 20) + 8),
    dict(p=4), dict(p=0),
    dict(n=0),
])
def test_every_other_table_takes_the_plain_sum(case):
    case = dict(case)
    dim, p, n = (case.pop(k, d) for k, d in (("dim", 4100), ("p", 3),
                                             ("n", 5)))
    case.setdefault("pitch", 4100)
    assert not rows.fused_pow_sum(_stand_in(**case), torch.zeros(n), dim, p)


# ---------------------------------------------------------------------------
# The plain routes, on the CPU


@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("width,dim", [(24, 24), (24, 17),
                                       (rows.GATHER_WIDE_MIN - 4,) * 2,
                                       (4100, 4100)])
def test_cpu_route_gives_the_rows_and_the_regularization_sum(p, width, dim):
    table = _table(30, width)
    ids = _ids(64, 30)                   # repeated ids
    before = dict(rows.launches)
    got, total = rows.gather_rows_pow_sum(table, ids, p, dim)
    assert rows.launches == before
    assert torch.equal(got, rows.gather_rows(table, ids, dim))
    assert total.dtype == torch.float32 and total.dim() == 0
    coef = 2e-6
    assert torch.equal(coef * total, regularization(coef, p, [got]))
    assert torch.equal(total, regularization(1.0, p, [got]))


def test_cpu_route_of_a_bf16_table_sums_the_widened_rows():
    table = _table(10, 40).to(torch.bfloat16)
    ids = _ids(12, 10)
    got, total = rows.gather_rows_pow_sum(table, ids, 3)
    assert got.dtype == torch.float32
    assert torch.equal(total, torch.sum(torch.abs(table[ids.long()].float())
                                        ** 3))


def test_no_ids_give_no_rows_and_zero():
    got, total = rows.gather_rows_pow_sum(_table(5, 8),
                                          torch.zeros(0, dtype=torch.int32), 2)
    assert got.shape == (0, 8) and float(total) == 0.0


def test_cpu_route_checks_its_arguments():
    with pytest.raises(ValueError):
        rows.gather_rows_pow_sum(_table(5, 8), _ids(3, 5), 2, dim=9)
    with pytest.raises(TypeError):
        rows.gather_rows_pow_sum(_table(5, 8).double(), _ids(3, 5), 2)


# ---------------------------------------------------------------------------
# The step


def _cfg(model_name="RESCAL", **over):
    kw = dict(model_name=model_name, hidden_dim=8, gamma=12.0, lr=0.1,
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


def _spy(monkeypatch):
    """Calls of the relation gather (gather_rows_matvec, which sums the
    value for p > 0): (table, p, dim) each."""
    calls = []
    real = ke_model.gather_rows_matvec

    def spy(table, ids, vecs, head, p, dim=None):
        calls.append((table, p, dim))
        return real(table, ids, vecs, head, p, dim)

    monkeypatch.setattr(ke_model, "gather_rows_matvec", spy)
    return calls


@pytest.mark.parametrize("neg_head", [True, False])
@pytest.mark.parametrize("norm", [1, 2, 3])
def test_factored_step_takes_the_relation_value_from_the_gather(
        monkeypatch, neg_head, norm):
    calls = _spy(monkeypatch)
    cfg = _cfg(regularization_norm=norm)
    model = KEModel(cfg, 40, 5, device="cpu")
    state = model.init_state()
    h, r, t, neg = _batch(40, 5, 16, 16)
    ent0 = state.entity.emb.clone()
    rel0 = state.relation.emb.clone()
    _, log, _ = model.loss_and_grads(state, h, r, t, neg, None,
                                     neg_head=neg_head)
    assert calls == [(state.relation, norm, model.relation_dim)]
    ent_rows = ent0[torch.cat([h, t, neg]).long()]
    want = (regularization(cfg.regularization_coef, norm, [ent_rows])
            + regularization(cfg.regularization_coef, norm,
                             [rel0[r.long()]]))
    assert torch.equal(log["regularization"], want)


@pytest.mark.parametrize("over", [dict(regularization_coef=0.0),
                                  dict(regularization_norm=0)])
def test_factored_step_without_regularization_sums_nothing(monkeypatch,
                                                           over):
    calls = _spy(monkeypatch)
    model = KEModel(_cfg(**over), 40, 5, device="cpu")
    state = model.init_state()
    _, log, _ = model.loss_and_grads(state, *_batch(40, 5, 16, 16),
                                     None, neg_head=True)
    assert calls == [(state.relation, 0, model.relation_dim)]
    assert "regularization" not in log


@pytest.mark.parametrize("model_name", ["TransE_l2", "DistMult"])
def test_other_families_never_take_it(monkeypatch, model_name):
    calls = _spy(monkeypatch)
    model = KEModel(_cfg(model_name), 40, 5, device="cpu")
    model.train_step(model.init_state(), *_batch(40, 5, 16, 16), None,
                     neg_head=False)
    assert calls == []


# ---------------------------------------------------------------------------
# On the card


CARD_ROWS = 1000
CARD_TABLE = 300


def _fp64_sum(table, ids, p):
    return float(torch.sum(torch.abs(table[ids.long()].double()) ** p))


@pytest.mark.card
@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("dim", [2048, 4100, 250_000])
def test_fused_sum_on_the_card(card, p, dim):
    table = _table(CARD_TABLE, dim, device=card)
    ids = _ids(CARD_ROWS, CARD_TABLE, device=card)
    assert len(set(ids.tolist())) < CARD_ROWS      # repeated ids
    assert rows.fused_pow_sum(table, ids, dim, p)
    before = dict(rows.launches)
    got, total = rows.gather_rows_pow_sum(table, ids, p)
    again, total2 = rows.gather_rows_pow_sum(table, ids, p)
    torch.cuda.synchronize(card)
    assert rows.launches["gather_rows_pow_sum"] == (
        before["gather_rows_pow_sum"] + 2)
    assert rows.launches["gather_rows"] == before["gather_rows"] + 2
    want = _fp64_sum(table, ids, p)
    assert abs(float(total) - want) <= 1e-6 * want
    assert total.dtype == torch.float32 and total.dim() == 0
    assert torch.equal(total.view(torch.int32), total2.view(torch.int32))
    plain = rows.launch_gather(table, ids, dim, "wide")
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    assert torch.equal(again.view(torch.int32), plain.view(torch.int32))


@pytest.mark.card
def test_fused_sum_replays_give_the_same_bits(card):
    dim = 250_000
    table = _table(CARD_TABLE, dim, device=card)
    ids = _ids(CARD_ROWS, CARD_TABLE, device=card)
    eager_rows, eager = rows.gather_rows_pow_sum(table, ids, 3)
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(stream):
        rows.gather_rows_pow_sum(table, ids, 3)      # warm on the stream
    torch.cuda.current_stream(card).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_rows, g_total = rows.gather_rows_pow_sum(table, ids, 3)
    seen = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize(card)
        seen.append(g_total.clone())
        assert torch.equal(g_rows.view(torch.int32),
                           eager_rows.view(torch.int32))
    for total in seen:
        assert torch.equal(total.view(torch.int32), eager.view(torch.int32))


def _cpu_state(state):
    from dglke_tpu_torch.models.ke_model import TrainState
    from dglke_tpu_torch.ops.embedding import EmbeddingState

    def table(t):
        return EmbeddingState(t.emb.cpu().clone(), t.state_sum.cpu().clone())

    return TrainState(table(state.entity), table(state.relation))


@pytest.mark.card
@pytest.mark.parametrize("neg_head", [True, False])
def test_factored_rescal_step_on_the_card(card, neg_head):
    n_ent, n_rel, b, k = 2000, 40, 64, 16
    cfg = _cfg(hidden_dim=500, gamma=24.0, lr=0.03, batch_size=b,
               neg_sample_size=k, regularization_coef=2e-6)
    gpu, cpu = (KEModel(cfg, n_ent, n_rel, device=d) for d in (card, "cpu"))
    state = gpu.init_state()
    assert gpu._rescal_factored(state)
    host = _cpu_state(state)
    ids = _batch(n_ent, n_rel, b, cfg.num_chunks * k, seed=7)
    h, r, t, neg = (x.to(card) for x in ids)
    coef, p = cfg.regularization_coef, cfg.regularization_norm
    three_pass = (
        regularization(coef, p, [rows.gather_rows(
            state.entity.emb, torch.cat([h, t, neg]))])
        + regularization(coef, p, [rows.gather_rows(state.relation.emb, r)]))
    before = dict(rows.launches)
    _, log = gpu.train_step(state, h, r, t, neg, None, neg_head=neg_head)
    _, clog = cpu.train_step(host, *ids, None, neg_head=neg_head)
    torch.cuda.synchronize(card)
    for key in ("gather_rows_pow_sum", "gather_rows_matvec"):
        assert rows.launches[key] == before[key] + 1, key
    got, want = float(log["regularization"]), float(three_pass)
    assert abs(got - want) <= 1e-6 * want
    pairs = [("loss", log["loss"], clog["loss"])]
    for name in ("entity", "relation"):
        g, c = getattr(state, name), getattr(host, name)
        pairs += [(f"{name} emb", g.emb, c.emb),
                  (f"{name} state_sum", g.state_sum, c.state_sum)]
    for what, a, c in pairs:
        assert torch.allclose(a, c.to(card), rtol=1e-4, atol=1e-5), what
