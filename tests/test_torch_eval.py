"""dglke_tpu_torch's filtered full-entity ranking against the JAX package's:
identical tables and eval batches give identical integer ranks.

The tables plant exact ties: a run of identical entity rows (candidates
that tie with each other) and, for one query, a second entity whose row
equals the true answer's and which is itself a true answer (filtered), so
the exact subtraction of the filtered count is exercised on a tie.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.data.dataset import KGDataset as JaxDataset
from dglke_tpu.data.sampler import EvalSampler as JaxSampler
from dglke_tpu.data.sampler import FilterIndex as JaxFilter
from dglke_tpu.models.ke_model import KEModel as JaxModel
from dglke_tpu.models.ke_model import TrainState as JaxState
from dglke_tpu.ops.embedding import EmbeddingState as JaxTable
from dglke_tpu.trainer import evaluate as jax_evaluate
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import KGDataset
from dglke_tpu_torch.data.sampler import EvalSampler, FilterIndex
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.trainer import evaluate
from dglke_tpu_torch.utils.convert import state_from_numpy

torch.set_num_threads(2)

N_ENT, N_REL, DIM = 50, 4, 16


def _triples(rng, n):
    h = rng.integers(0, N_ENT, n)
    r = rng.integers(0, N_REL, n)
    t = rng.integers(0, N_ENT, n)
    return h, r, t


def _setup():
    rng = np.random.default_rng(0)
    train = _triples(rng, 300)
    test = _triples(rng, 37)
    # query 0 has two true tails, 20 and 21, with identical rows
    test[0][0], test[1][0], test[2][0] = 3, 1, 20
    train = tuple(np.concatenate([a, [b]])
                  for a, b in zip(train, (3, 1, 21)))
    ent = (rng.standard_normal((N_ENT, DIM)) * 0.3).astype(np.float32)
    ent[11:15] = ent[10]            # candidates that tie with each other
    ent[21] = ent[20]               # a filtered tie with the true answer
    rel = (rng.standard_normal((N_REL, DIM)) * 0.3).astype(np.float32)
    jstate = JaxState(JaxTable(jnp.asarray(ent), jnp.zeros(N_ENT)),
                      JaxTable(jnp.asarray(rel), jnp.zeros(N_REL)), None,
                      jnp.asarray(0, jnp.int32))
    kw = dict(name="ties", n_entities=N_ENT, n_relations=N_REL,
              train=train, test=test)
    return JaxDataset(**kw), KGDataset(**kw), jstate


JDS, PDS, JSTATE = _setup()


def _models(model_name):
    kw = dict(model_name=model_name, hidden_dim=DIM, gamma=4.0,
              batch_size_eval=8)
    return (JaxConfig(**kw), JaxModel(JaxConfig(**kw), N_ENT, N_REL),
            KGEConfig(**kw), KEModel(KGEConfig(**kw), N_ENT, N_REL,
                                     device="cpu"))


@pytest.mark.parametrize("block", [None, 16], ids=["one_block", "blocks16"])
@pytest.mark.parametrize("mode", ["head", "tail"])
@pytest.mark.parametrize("model_name", ["TransE_l2", "TransE_l1"])
def test_eval_ranks_identical(model_name, mode, block):
    _, jm, _, pm = _models(model_name)
    pstate = state_from_numpy(jax.device_get(JSTATE), device="cpu")
    jsampler = JaxSampler(JDS, "test", 8, mode, JaxFilter(JDS))
    psampler = EvalSampler(PDS, "test", 8, mode, FilterIndex(PDS))
    n = 0
    for jb, pb in zip(jsampler, psampler):
        for k in ("h", "r", "t", "filter_ids", "filter_mask"):
            np.testing.assert_array_equal(pb[k], jb[k])
        want = np.asarray(jm.eval_ranks(
            JSTATE, jb["h"], jb["r"], jb["t"], jb["filter_ids"],
            jb["filter_mask"], neg_head=jb["neg_head"], block=block))
        got = pm.eval_ranks(
            pstate, *(torch.from_numpy(pb[k]) for k in
                      ("h", "r", "t", "filter_ids", "filter_mask")),
            neg_head=pb["neg_head"], block=block)
        np.testing.assert_array_equal(got.numpy(), want)
        n += 1
    assert n == len(psampler) == 5


def test_evaluate_metrics_identical():
    jcfg, jm, pcfg, pm = _models("TransE_l2")
    pstate = state_from_numpy(jax.device_get(JSTATE), device="cpu")
    quiet = lambda *a: None  # noqa: E731
    want = jax_evaluate(jcfg, JDS, jm, JSTATE, "test", log=quiet)
    got = evaluate(pcfg, PDS, pm, pstate, "test", log=quiet)
    assert got == want


@pytest.mark.parametrize("mode", ["head", "tail"])
def test_raw_eval_ranks_within_the_self_tie(mode):
    """Unfiltered ranking counts the true entity's own candidate when its
    score reaches the positive score, which is computed by another formula:
    that comparison is a tie up to rounding, so the two frameworks may
    differ there, by 1 for the true entity and 1 for each entity whose row
    equals its row, and nowhere else."""
    _, jm, _, pm = _models("TransE_l2")
    pstate = state_from_numpy(jax.device_get(JSTATE), device="cpu")
    ent = np.asarray(JSTATE.entity.emb)
    zeros = np.zeros((8, 8), np.int32)
    for pb in EvalSampler(PDS, "test", 8, mode, None):
        true = pb["h"] if mode == "head" else pb["t"]
        twins = (ent[true][:, None, :] == ent[None, :, :]).all(-1).sum(1)
        want = np.asarray(jm.eval_ranks(
            JSTATE, pb["h"], pb["r"], pb["t"], zeros,
            zeros.astype(np.uint8), neg_head=pb["neg_head"]))
        got = pm.eval_ranks(
            pstate, *(torch.from_numpy(pb[k]) for k in ("h", "r", "t")),
            torch.from_numpy(zeros), torch.from_numpy(zeros).to(torch.uint8),
            neg_head=pb["neg_head"]).numpy()
        assert np.all(np.abs(got - want) <= twins), (got, want, twins)


def test_eval_tie_with_filtered_true_answer_ranks_first():
    """Query 0's true tail 20 ties exactly with entity 21, which is also a
    true tail and so filtered: the tie must not push the rank past what the
    other candidates give."""
    _, _, _, pm = _models("TransE_l2")
    pstate = state_from_numpy(jax.device_get(JSTATE), device="cpu")
    batch = next(iter(EvalSampler(PDS, "test", 8, "tail", FilterIndex(PDS))))
    assert set(batch["filter_ids"][0][batch["filter_mask"][0] > 0]) >= {20,
                                                                       21}
    ranks = pm.eval_ranks(pstate, *(torch.from_numpy(batch[k]) for k in
                                    ("h", "r", "t", "filter_ids",
                                     "filter_mask")), neg_head=False)
    raw = pm.eval_ranks(pstate, *(torch.from_numpy(batch[k]) for k in
                                  ("h", "r", "t")),
                        torch.zeros((8, 8), dtype=torch.int32),
                        torch.zeros((8, 8), dtype=torch.uint8),
                        neg_head=False)
    assert int(ranks[0]) < int(raw[0])
