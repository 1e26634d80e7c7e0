"""TransE scores and the loss subsystem of dglke_tpu_torch against the JAX
package: values and gradients, from the same numpy inputs.

Tolerances: rtol 1e-5 / atol 1e-5.  Both sides compute in fp32 on the CPU,
with sums (and the L2 expansion's matmul) taken in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.models import loss as jax_loss
from dglke_tpu.models import score_functions as jax_sf
from dglke_tpu.models.ke_model import KEModel as JaxModel
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.models import loss as pt_loss
from dglke_tpu_torch.models import score_functions as pt_sf
from dglke_tpu_torch.models.ke_model import KEModel

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-5
C, BC, K, D = 2, 4, 5, 16          # chunks, positives per chunk, negatives
B = C * BC


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.3).astype(np.float32)
            for s in shapes]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _torch_value_and_grad(fn, arrays):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("dist_ord", [1, 2])
def test_transe_pos_score(dist_ord):
    h, r, t, w = _arrays(0, (B, D), (B, D), (B, D), (B,))
    jsf = jax_sf.TransEScore(gamma=4.0, dist_ord=dist_ord)
    psf = pt_sf.TransEScore(gamma=4.0, dist_ord=dist_ord)
    want, want_g = jax.value_and_grad(
        lambda h, r, t: jnp.sum(jsf.pos_score(h, r, t) * w),
        argnums=(0, 1, 2))(h, r, t)
    got, got_g = _torch_value_and_grad(
        lambda h, r, t: torch.sum(psf.pos_score(h, r, t)
                                  * torch.from_numpy(w)), [h, r, t])
    _close(got, want)
    for g, wg in zip(got_g, want_g):
        _close(g, wg)


@pytest.mark.parametrize("neg_head", [True, False])
@pytest.mark.parametrize("dist_ord", [1, 2])
def test_transe_neg_score(dist_ord, neg_head):
    emb, rel, neg, w = _arrays(1, (B, D), (B, D), (C * K, D), (C, BC, K))
    jsf = jax_sf.TransEScore(gamma=4.0, dist_ord=dist_ord)
    psf = pt_sf.TransEScore(gamma=4.0, dist_ord=dist_ord)
    kw = dict(neg_head=neg_head, num_chunks=C, chunk_size=BC,
              neg_sample_size=K)
    want, want_g = jax.value_and_grad(
        lambda e, r, n: jnp.sum(jsf.neg_score(e, r, n, **kw) * w),
        argnums=(0, 1, 2))(emb, rel, neg)
    got, got_g = _torch_value_and_grad(
        lambda e, r, n: torch.sum(psf.neg_score(e, r, n, **kw)
                                  * torch.from_numpy(w)), [emb, rel, neg])
    _close(got, want)
    for g, wg in zip(got_g, want_g):
        _close(g, wg)


@pytest.mark.parametrize("neg_deg_sample", [True, False])
@pytest.mark.parametrize("neg_head", [True, False])
def test_pos_neg_scores_with_neg_deg_sample(neg_head, neg_deg_sample):
    """KEModel._pos_neg_scores, with the batch's own side entities as extra
    negatives and the self-match diagonal masked."""
    h, t, r, neg = _arrays(2, (B, D), (B, D), (B, D), (C * K, D))
    kw = dict(model_name="TransE_l2", hidden_dim=D, gamma=4.0,
              neg_sample_size=K, batch_size=B)
    jm = JaxModel(JaxConfig(**kw), 50, 5)
    pm = KEModel(KGEConfig(**kw), 50, 5, device="cpu")
    sk = dict(neg_head=neg_head, num_chunks=C, chunk_size=BC,
              neg_sample_size=K, neg_deg_sample=neg_deg_sample)
    jpos, jneg, jk = jm._pos_neg_scores((h, t), r, neg, None, **sk)
    ppos, pneg, pk = pm._pos_neg_scores(
        (torch.from_numpy(h), torch.from_numpy(t)), torch.from_numpy(r),
        torch.from_numpy(neg), **sk)
    assert pk == jk == (BC + K if neg_deg_sample else K)
    assert pneg.shape == (B, pk)
    _close(ppos, jpos)
    _close(pneg, jneg)


def _loss_cases():
    for genre in ("Hinge", "Logistic", "Logsigmoid", "BCE"):
        modes = ["pointwise", "adversarial"]
        if genre in ("Hinge", "Logistic"):
            modes.append("pairwise")
        for mode in modes:
            for weighted in (False, True):
                yield pytest.param(genre, mode, weighted,
                                   id=f"{genre}-{mode}-"
                                   f"{'impts' if weighted else 'unweighted'}")


@pytest.mark.parametrize("genre,mode,weighted", list(_loss_cases()))
def test_loss_value_and_grads(genre, mode, weighted):
    pos, neg = _arrays(3, (B,), (B, K))
    pos, neg = pos * 10, neg * 10      # reach the criteria's tails
    w = (np.random.default_rng(4).uniform(0.5, 2.0, B).astype(np.float32)
         if weighted else None)
    kw = dict(loss_genre=genre, neg_adversarial_sampling=mode == "adversarial",
              adversarial_temperature=0.7, pairwise=mode == "pairwise",
              margin=1.5)
    jgen, pgen = jax_loss.LossGenerator(**kw), pt_loss.LossGenerator(**kw)

    def jfn(p, n):
        loss, log = jgen.get_total_loss(p, n, None if w is None
                                        else jnp.asarray(w))
        return loss, log

    (want, want_log), want_g = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(pos, neg)
    tp = torch.from_numpy(pos.copy()).requires_grad_()
    tn = torch.from_numpy(neg.copy()).requires_grad_()
    got, got_log = pgen.get_total_loss(
        tp, tn, None if w is None else torch.from_numpy(w))
    got_g = torch.autograd.grad(got, (tp, tn))
    _close(got.detach(), want)
    assert set(got_log) == set(want_log)
    for k in want_log:
        _close(got_log[k].detach(), want_log[k])
    for g, wg in zip(got_g, want_g):
        _close(g, wg)


@pytest.mark.parametrize("norm", [2, 3])
def test_regularization_value_and_grads(norm):
    a, b = _arrays(5, (12, D), (4, D))
    want, want_g = jax.value_and_grad(
        lambda a, b: jax_loss.regularization(1e-3, norm, [a, b]),
        argnums=(0, 1))(a, b)
    got, got_g = _torch_value_and_grad(
        lambda a, b: pt_loss.regularization(1e-3, norm, [a, b]), [a, b])
    _close(got, want)
    for g, wg in zip(got_g, want_g):
        _close(g, wg)


def test_loss_generator_refuses_what_jax_refuses():
    with pytest.raises(ValueError):
        pt_loss.LossGenerator(pairwise=True, neg_adversarial_sampling=True,
                              loss_genre="Logistic")
    with pytest.raises(ValueError):
        pt_loss.LossGenerator(pairwise=True, loss_genre="BCE")
    with pytest.raises(ValueError):
        pt_loss.LossGenerator(loss_genre="Squared")
