"""TransE_l2's fused loss route (ops/transe_l2.py, KEModel._transe_l2_fused):

  * the plain fused version against the autograd route it replaces
    (KEModel._rows_loss_and_grads with the predicate off), on the loss,
    each log value and every row gradient: both orientations, the
    self-adversarial weights on and off at T != 1, edge weights,
    regularization at norms 2 and 3 and a coefficient of 0, a batch share
    of 1/2, K and D off the kernels' 32-wide tiles, one chunk, one positive
    a chunk;
  * the predicate: true for TransE_l2 in fp32 with the pointwise
    Logsigmoid loss, false for TransE_l1, TransR, RESCAL, bf16 compute or
    tables, every other loss genre, pairwise losses and neg_deg_sample,
    for a loss generator or score function whose class replaces the loss
    or the scores (the autograd route then calls the replacement), and for
    rows off the route's layout;
  * on the CPU the plain version runs: nothing is built, no launch counted;
  * on a card (the ``card`` marker; skipped without one): the kernels
    against the plain version on the card and against the autograd route
    at both benchmark cells' shapes (FB15k: 5 chunks of 200 x 200
    negatives x 400; ogbl-wikikg2: 4 of 128 x 128 x 500) in both
    orientations; two replays of a captured group of steps leave the
    tables and the Adagrad state bit-equal; ``rows.launches
    ["transe_l2_loss"]`` counts two launches a step through the device
    pipeline's replays, and none for RESCAL, bf16 compute and TransE_l1;
    K and D off four, rows off 16-byte boundaries and strided rows take
    the kernels' element loads; K = 1,024 and 2,048, either side of the
    largest row PyTorch's softmax takes in the warp order the row pass
    repeats.

Tolerances.  CPU: rtol 1e-5 on the loss and the log values (fp32 values,
the fused route's sums in fp64), gradients within 2e-6 of their largest
element (the same mathematics, its terms summed in another order: the
cases read ~2e-7).  Card: kernels against the plain version and the
autograd route within 1e-5 of the largest element for gradients and
rtol 1e-5 for the log values, since the kernels' products add their fp32
terms in another order than cuBLAS (TF32 off on both) and the distances of
near ties differ by a rounding; and the norms of each part's gradient
within 1e-9 of the autograd route's (kgbench's check allows 3e-9 on the
tables' norms, and reading the sums a row's elements share in another
order moved them by up to 6e-9).  Above K = 1,024 PyTorch's softmax sums
each row in a block's order, not the warp's: the norms are held within
1e-9 there too (4.1e-10 at K = 2,048 on an H100 under PyTorch 2.11), so
a PyTorch whose orders move them further fails here first.

This file imports nothing of JAX, so that its card tests run on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_transe_l2_fused.py -m card
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import synthetic_dataset
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.models.loss import LossGenerator
from dglke_tpu_torch.models.pipeline_step import DevicePipelineStep
from dglke_tpu_torch.ops import rows, transe_l2
from dglke_tpu_torch.trainer import DevicePipeline

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(**over):
    kw = dict(model_name="TransE_l2", hidden_dim=24, gamma=6.0, lr=0.25,
              batch_size=12, neg_sample_size=8,
              neg_adversarial_sampling=True, adversarial_temperature=0.7,
              regularization_coef=1e-3, regularization_norm=3, seed=3)
    kw.update(over)
    return KGEConfig(**kw)


def _rows(b, c, k, d, seed=0, device="cpu", weights=False):
    rng = np.random.default_rng(seed)
    ent = rng.uniform(-0.3, 0.3, (2 * b + c * k, d)).astype(np.float32)
    rel = rng.uniform(-0.3, 0.3, (b, d)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, b).astype(np.float32) if weights else None
    conv = (lambda x: None if x is None
            else torch.from_numpy(x).to(device))
    return conv(ent), conv(rel), conv(w)


def _both_routes(model, ent, rel, w, *, b, c, k, neg_head, monkeypatch):
    """(fused, autograd): each (loss, log, (ent_grads, rel_grads))."""
    kw = dict(b=b, num_chunks=c, chunk_size=b // c, neg_sample_size=k,
              neg_head=neg_head)
    assert model._transe_l2_fused(ent, rel, b=b, num_chunks=c,
                                  chunk_size=b // c, neg_sample_size=k)
    fused = model._rows_loss_and_grads(ent, rel, None, w, **kw)
    with monkeypatch.context() as m:
        m.setattr(KEModel, "_transe_l2_fused", lambda *a, **kw: False)
        auto = model._rows_loss_and_grads(ent, rel, None, w, **kw)
    return fused, auto


def _close_grads(got, want, rel_tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= rel_tol * scale


def _close_logs(got, want, rtol):
    assert list(got) == list(want)         # the same keys, in order
    for key in want:
        assert got[key].dim() == 0
        assert abs(float(got[key]) - float(want[key])) <= rtol * abs(
            float(want[key])), key


# ---------------------------------------------------------------------------
# The plain fused version against the autograd route, on the CPU


CASES = {
    "tail": dict(),
    "head": dict(neg_head=True),
    "no_adv": dict(cfg=dict(neg_adversarial_sampling=False)),
    "no_adv_head": dict(neg_head=True,
                        cfg=dict(neg_adversarial_sampling=False)),
    "temperature_2": dict(cfg=dict(adversarial_temperature=2.0)),
    "weights": dict(weights=True),
    "weights_head_no_adv": dict(weights=True, neg_head=True,
                                cfg=dict(neg_adversarial_sampling=False)),
    "norm_2": dict(cfg=dict(regularization_norm=2)),
    "coef_0": dict(cfg=dict(regularization_coef=0.0)),
    "share_half": dict(share=True),
    "share_half_head_weights": dict(share=True, neg_head=True, weights=True),
    "off_tile": dict(shape=(12, 3, 37, 45)),
    "one_chunk": dict(shape=(9, 1, 33, 40)),
    "one_positive_a_chunk": dict(shape=(5, 5, 7, 33), neg_head=True),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_plain_fused_route_is_the_autograd_route(case, monkeypatch):
    spec = CASES[case]
    b, c, k, d = spec.get("shape", (12, 3, 8, 24))
    model = KEModel(_cfg(hidden_dim=d, batch_size=b, neg_sample_size=k,
                         **spec.get("cfg", {})), 50, 5, device="cpu")
    if spec.get("share"):
        model.plan = SimpleNamespace(n=2)
    ent, rel, w = _rows(b, c, k, d, weights=spec.get("weights", False))
    before = dict(rows.launches)
    fused, auto = _both_routes(model, ent, rel, w, b=b, c=c, k=k,
                               neg_head=spec.get("neg_head", False),
                               monkeypatch=monkeypatch)
    assert rows.launches == before and rows._libs == {}
    assert fused[2][2] is None and auto[2][2] is None
    assert fused[0].dim() == 0
    assert abs(float(fused[0]) - float(auto[0])) <= 1e-5 * float(auto[0])
    _close_logs(fused[1], auto[1], 1e-5)
    assert ("regularization" in fused[1]) == (
        model.config.regularization_coef > 0)
    _close_grads(fused[2][:2], auto[2][:2], 2e-6)


def test_train_step_takes_the_fused_route(monkeypatch):
    """A whole CPU step through the fused route gives the tables the
    autograd route gives, to rounding."""
    b, k = 12, 8
    cfg = _cfg(batch_size=b, neg_sample_size=k)
    model = KEModel(cfg, 50, 5, device="cpu")
    states = [model.init_state(), model.init_state()]
    rng = np.random.default_rng(4)
    h, t = (torch.from_numpy(rng.integers(0, 50, b)) for _ in range(2))
    r = torch.from_numpy(rng.integers(0, 5, b))
    neg = torch.from_numpy(rng.integers(0, 50, (b // k or 1) * k))
    seen = []
    real = transe_l2.loss_and_grads

    def spy(*args, **kwargs):
        seen.append(kwargs["neg_head"])
        return real(*args, **kwargs)

    monkeypatch.setattr(transe_l2, "loss_and_grads", spy)
    _, log = model.train_step(states[0], h, r, t, neg, None, neg_head=True)
    monkeypatch.setattr(KEModel, "_transe_l2_fused",
                        lambda *a, **kw: False)
    _, want = model.train_step(states[1], h, r, t, neg, None,
                               neg_head=True)
    assert seen == [True]
    _close_logs(log, want, 1e-5)
    for name in ("entity", "relation"):
        g, w = getattr(states[0], name), getattr(states[1], name)
        np.testing.assert_allclose(g.emb.numpy(), w.emb.numpy(), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(g.state_sum.numpy(),
                                   w.state_sum.numpy(), rtol=1e-4,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# The predicate


def test_predicate_holds_for_transe_l2_in_fp32_with_logsigmoid():
    model = KEModel(_cfg(), 50, 5, device="cpu")
    assert model._transe_l2_fused()
    assert KEModel(_cfg(neg_adversarial_sampling=False,
                        regularization_coef=0.0), 50, 5,
                   device="cpu")._transe_l2_fused()


@pytest.mark.parametrize("over", [
    dict(model_name="TransE_l1"),
    dict(model_name="TransR"),
    dict(model_name="RESCAL"),
    dict(compute_dtype="bfloat16"),
    dict(emb_dtype="bfloat16"),
    dict(loss_genre="Hinge"),
    dict(loss_genre="Logistic"),
    dict(loss_genre="BCE"),
    dict(loss_genre="Logistic", pairwise=True,
         neg_adversarial_sampling=False),
    dict(loss_genre="Hinge", pairwise=True, neg_adversarial_sampling=False),
    dict(neg_deg_sample=True),
], ids=["TransE_l1", "TransR", "RESCAL", "bf16_compute", "bf16_tables",
        "Hinge", "Logistic", "BCE", "pairwise_logistic", "pairwise_hinge",
        "neg_deg_sample"])
def test_predicate_is_false_for_every_other_case(over):
    assert not KEModel(_cfg(**over), 50, 5, device="cpu")._transe_l2_fused()


class _OwnLoss(LossGenerator):
    def get_total_loss(self, pos, neg, edge_weight=None):
        loss, log = super().get_total_loss(pos, neg, edge_weight)
        return 2.0 * loss, log


@pytest.mark.parametrize("how", ["subclass", "patched_class", "score_fn"])
def test_a_replaced_loss_or_score_keeps_the_autograd_route(how,
                                                           monkeypatch):
    """The route computes LossGenerator.get_total_loss and TransEScore's
    scores itself: where either is replaced, the step calls the
    replacement through autograd."""
    b, c, k, d = 12, 3, 8, 24
    ent, rel, _ = _rows(b, c, k, d)
    chunks = dict(b=b, num_chunks=c, chunk_size=b // c, neg_sample_size=k)
    model = KEModel(_cfg(regularization_coef=0.0), 50, 5, device="cpu")
    want = model._rows_loss_and_grads(ent, rel, None, None, **chunks,
                                      neg_head=False)
    calls = []
    if how == "subclass":
        lg = model.loss_gen
        model.loss_gen = _OwnLoss(lg.loss_genre, lg.neg_adversarial_sampling,
                                  lg.adversarial_temperature, lg.pairwise,
                                  lg.margin)
    elif how == "patched_class":
        orig = LossGenerator.get_total_loss

        def doubled(self, pos, neg, edge_weight=None):
            calls.append(pos.shape)
            loss, log = orig(self, pos, neg, edge_weight)
            return 2.0 * loss, log
        monkeypatch.setattr(LossGenerator, "get_total_loss", doubled)
    else:
        sf = model.score_fn
        model.score_fn = type("OwnScore", (type(sf),), {})(sf.gamma,
                                                            sf.dist_ord)
    assert not model._transe_l2_fused()
    assert not model._transe_l2_fused(ent, rel, **chunks)
    got = model._rows_loss_and_grads(ent, rel, None, None, **chunks,
                                     neg_head=False)
    factor = 1.0 if how == "score_fn" else 2.0
    assert calls == ([(b,)] if how == "patched_class" else [])
    assert abs(float(got[0]) - factor * float(want[0])) <= 1e-6 * float(
        got[0])
    _close_grads([g / factor for g in got[2][:2]], want[2][:2], 2e-6)


@pytest.mark.parametrize("change", ["fp64", "rows", "rel_rows", "chunks"])
def test_rows_the_kernels_do_not_take_keep_the_autograd_route(change):
    b, c, k, d = 12, 3, 8, 24
    ent, rel, _ = _rows(b, c, k, d)
    shape = dict(b=b, num_chunks=c, chunk_size=b // c, neg_sample_size=k)
    if change == "fp64":
        ent, rel = ent.double(), rel.double()
    elif change == "rows":
        ent = ent[:-1]
    elif change == "rel_rows":
        rel = rel[:, :-1]
    else:
        shape["chunk_size"] = 5
    model = KEModel(_cfg(), 50, 5, device="cpu")
    assert model._transe_l2_fused()
    assert not model._transe_l2_fused(ent, rel, **shape)
    with pytest.raises(ValueError, match="do not fit"):
        transe_l2.loss_and_grads(ent, rel, None, **shape, neg_head=False,
                                 gamma=6.0, adversarial=True,
                                 temperature=1.0, share=1.0, reg_coef=0.0,
                                 reg_pow=0)


# ---------------------------------------------------------------------------
# On a card


FB15K = (1000, 5, 200, 400)        # b, chunks, k, dim
WIKIKG2 = (512, 4, 128, 500)


def _card_args(k, neg_head, reg_pow=3):
    return dict(neg_head=neg_head, gamma=19.9, adversarial=True,
                temperature=1.0, share=1.0, reg_coef=1e-9, reg_pow=reg_pow)


@pytest.mark.card
@pytest.mark.parametrize("neg_head", [False, True], ids=["tail", "head"])
@pytest.mark.parametrize("shape", [FB15K, WIKIKG2], ids=["fb15k", "wikikg2"])
def test_kernels_match_the_plain_version_and_autograd(card, shape, neg_head,
                                                      monkeypatch):
    b, c, k, d = shape
    ent, rel, _ = _rows(b, c, k, d, seed=11, device=card)
    ent, rel = ent * 0.2, rel * 0.2       # tables drawn in +-0.06
    chunks = dict(b=b, num_chunks=c, chunk_size=b // c, neg_sample_size=k)
    before = rows.launches["transe_l2_loss"]
    got = transe_l2.loss_and_grads(ent, rel, None, **chunks,
                                   **_card_args(k, neg_head))
    again = transe_l2.loss_and_grads(ent, rel, None, **chunks,
                                     **_card_args(k, neg_head))
    plain = transe_l2.loss_and_grads_plain(ent, rel, None, **chunks,
                                           **_card_args(k, neg_head))
    torch.cuda.synchronize(card)
    assert rows.launches["transe_l2_loss"] == before + 2 * transe_l2.LAUNCHES
    for x, y in zip(got[2:], again[2:]):            # the same bits
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert torch.equal(got[0].view(torch.int32), again[0].view(torch.int32))
    _close_logs(got[1], plain[1], 1e-5)
    _close_grads(got[2:], plain[2:], 1e-5)
    model = KEModel(_cfg(hidden_dim=d, batch_size=b, neg_sample_size=k,
                         gamma=19.9, adversarial_temperature=1.0,
                         regularization_coef=1e-9), 50, 5, device=card)
    fused, auto = _both_routes(model, ent, rel, None, b=b, c=c, k=k,
                               neg_head=neg_head, monkeypatch=monkeypatch)
    _close_logs(fused[1], auto[1], 1e-5)
    _close_grads(fused[2][:2], auto[2][:2], 1e-5)
    # kgbench's check compares the norms of the tables' gradients within
    # 3e-9: the sums shared by a row's elements are PyTorch's own, so the
    # norms of h's, t's, the negatives' and r's gradients agree far closer
    for x, y in zip(_parts(fused[2], b), _parts(auto[2], b)):
        gap = abs(float(x.double().norm()) - float(y.double().norm()))
        assert gap <= 1e-9 * float(y.double().norm())


def _parts(grads, b):
    ent, rel = grads[:2]
    return ent[:b], ent[b:2 * b], ent[2 * b:], rel


@pytest.mark.card
@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_kernels_match_the_plain_version_in_every_case(card, case):
    """The cases of the CPU comparison at their shapes (off the 32-wide
    tiles, and off four where the CPU's are)."""
    spec = CASES[case]
    b, c, k, d = spec.get("shape", (12, 3, 8, 24))
    cfg = _cfg(**spec.get("cfg", {}))
    ent, rel, w = _rows(b, c, k, d, device=card,
                        weights=spec.get("weights", False))
    reg = cfg.regularization_coef > 0
    args = dict(b=b, num_chunks=c, chunk_size=b // c, neg_sample_size=k,
                neg_head=spec.get("neg_head", False), gamma=cfg.gamma,
                adversarial=cfg.neg_adversarial_sampling,
                temperature=cfg.adversarial_temperature,
                share=0.5 if spec.get("share") else 1.0,
                reg_coef=cfg.regularization_coef if reg else 0.0,
                reg_pow=cfg.regularization_norm if reg else 0)
    got = transe_l2.loss_and_grads(ent, rel, w, **args)
    plain = transe_l2.loss_and_grads_plain(ent, rel, w, **args)
    torch.cuda.synchronize(card)
    assert abs(float(got[0]) - float(plain[0])) <= 1e-5 * float(plain[0])
    _close_logs(got[1], plain[1], 1e-5)
    _close_grads(got[2:], plain[2:], 1e-5)


LAYOUTS = {
    "k_odd": ((12, 3, 37, 44), "dense"),
    "d_odd": ((12, 3, 36, 45), "dense"),
    "both_odd": ((12, 3, 37, 45), "dense"),
    "unaligned": ((12, 3, 36, 44), "offset"),
    "strided": ((12, 3, 36, 44), "strided"),
}


@pytest.mark.card
@pytest.mark.parametrize("layout", list(LAYOUTS), ids=list(LAYOUTS))
def test_kernels_take_any_width_and_layout(card, layout, monkeypatch):
    """K or D off four, rows one element off a 16-byte boundary, and rows
    with a pitch wider than D: the route takes the kernels (element loads,
    or a contiguous copy of strided rows) and matches the plain version
    and the autograd route."""
    (b, c, k, d), how = LAYOUTS[layout]
    ent, rel, _ = _rows(b, c, k, d, device=card)
    if how == "offset":
        ent = torch.cat([ent.new_zeros(1), ent.reshape(-1)])[1:].view(
            ent.shape)
        rel = torch.cat([rel.new_zeros(1), rel.reshape(-1)])[1:].view(
            rel.shape)
        assert ent.data_ptr() % 16 and rel.data_ptr() % 16
    elif how == "strided":
        ent = torch.cat([ent, ent[:, :3]], 1)[:, :d]
        rel = torch.cat([rel, rel[:, :3]], 1)[:, :d]
        assert not ent.is_contiguous() and not rel.is_contiguous()
    model = KEModel(_cfg(hidden_dim=d, batch_size=b, neg_sample_size=k), 50,
                    5, device=card)
    chunks = dict(b=b, num_chunks=c, chunk_size=b // c, neg_sample_size=k)
    args = dict(chunks, neg_head=False, gamma=6.0, adversarial=True,
                temperature=0.7, share=1.0, reg_coef=1e-3, reg_pow=3)
    before = rows.launches["transe_l2_loss"]
    got = transe_l2.loss_and_grads(ent, rel, None, **args)
    plain = transe_l2.loss_and_grads_plain(ent, rel, None, **args)
    torch.cuda.synchronize(card)
    assert rows.launches["transe_l2_loss"] == before + transe_l2.LAUNCHES
    _close_logs(got[1], plain[1], 1e-5)
    _close_grads(got[2:], plain[2:], 1e-5)
    fused, auto = _both_routes(model, ent, rel, None, b=b, c=c, k=k,
                               neg_head=False, monkeypatch=monkeypatch)
    _close_logs(fused[1], auto[1], 1e-5)
    _close_grads(fused[2][:2], auto[2][:2], 1e-5)


@pytest.mark.card
@pytest.mark.parametrize("k", [1024, 2048], ids=["k1024", "k2048"])
def test_kernels_either_side_of_the_warp_softmax(card, k, monkeypatch):
    """The row pass sums each row's softmax in the order of PyTorch's warp
    softmax, which PyTorch takes up to K = 1,024 fp32 scores a row; above
    it PyTorch sums each row in a block's order.  On both sides the norms
    of each part's gradient agree with the autograd route's as closely as
    at the benchmark cells' shapes (1e-9), the gradients within 1e-5 of
    their largest element."""
    b, c, d = 256, 2, 128
    ent, rel, _ = _rows(b, c, k, d, seed=5, device=card)
    ent, rel = ent * 0.2, rel * 0.2
    model = KEModel(_cfg(hidden_dim=d, batch_size=b, neg_sample_size=k,
                         gamma=19.9, adversarial_temperature=1.0,
                         regularization_coef=1e-9), 50, 5, device=card)
    fused, auto = _both_routes(model, ent, rel, None, b=b, c=c, k=k,
                               neg_head=False, monkeypatch=monkeypatch)
    _close_logs(fused[1], auto[1], 1e-5)
    _close_grads(fused[2][:2], auto[2][:2], 1e-5)
    gaps = [abs(float(x.double().norm()) - float(y.double().norm()))
            / float(y.double().norm())
            for x, y in zip(_parts(fused[2], b), _parts(auto[2], b))]
    print(f"K = {k}: relative norm gaps (h, t, negatives, r) {gaps}")
    assert max(gaps) <= 1e-9


def _card_pipeline(card, model_name="TransE_l2", **over):
    n_ent, n_rel, b, k = 400, 12, 64, 16
    cfg = _cfg(model_name=model_name, hidden_dim=32, batch_size=b,
               neg_sample_size=k, **over)
    ds = synthetic_dataset(n_ent, n_rel, n_train=2000, n_valid=5, n_test=5,
                           seed=2)
    model = KEModel(cfg, n_ent, n_rel, device=card)
    pipe = DevicePipeline(model, ds, b, (b // k) * k, seed=5)
    return model, pipe


@pytest.mark.card
def test_two_replays_give_the_same_tables(card):
    """The same captured group replayed twice from the same tables and the
    same batches: tables and Adagrad states bit-equal."""
    model, pipe = _card_pipeline(card)
    state = model.init_state()
    steps = 3
    batches = [tuple(x.clone() if torch.is_tensor(x) else x for x in bt)
               for bt in (pipe.next_batch() for _ in range(steps))]
    tables = [state.entity.emb, state.entity.state_sum, state.relation.emb,
              state.relation.state_sum]
    start = [x.clone() for x in tables]

    def group():
        for h, r, t, neg, impts, neg_head in batches:
            model.train_step(state, h, r, t, neg, impts, neg_head=neg_head)

    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        group()                                  # warm on the stream
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        group()
    seen = []
    for _ in range(2):
        for x, x0 in zip(tables, start):
            x.copy_(x0)
        graph.replay()
        torch.cuda.synchronize(card)
        seen.append([x.clone() for x in tables])
    for a, b in zip(*seen):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not torch.equal(seen[0][0], start[0])     # the group trained


@pytest.mark.card
@pytest.mark.parametrize("model_name,over,per_step", [
    ("TransE_l2", {}, transe_l2.LAUNCHES),
    ("RESCAL", {}, 0),
    ("TransE_l2", dict(compute_dtype="bfloat16"), 0),
    ("TransE_l1", {}, 0),
], ids=["TransE_l2", "RESCAL", "bf16", "TransE_l1"])
def test_device_pipeline_counts_the_fused_launches(card, model_name, over,
                                                   per_step):
    model, pipe = _card_pipeline(card, model_name, **over)
    state = model.init_state()
    # even s: every call starts head-first, so one graph serves calls 2, 3
    s, calls = 4, 3                  # eager, capture and replay, replay
    fused = DevicePipelineStep(model, pipe, s)
    before = dict(rows.launches)
    for _ in range(calls):
        fused(state)
    torch.cuda.synchronize(card)
    assert len(fused.graphs) == 1 and fused.replays == 2
    assert rows.launches["transe_l2_loss"] - before["transe_l2_loss"] == (
        per_step * s * calls)
