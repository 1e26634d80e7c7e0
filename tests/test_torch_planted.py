"""The planted-structure quality gates of tests/test_planted_quality.py for
the six families ported after TransE (and TransE_l1), through the port's
own train() and evaluate() on the CPU: filtered MRR >= 0.85 and HITS@10
>= 0.99 with the JAX package's calibrated configs.  TransE_l2's gate is in
tests/test_torch_trainer.py."""

import pytest
import torch

from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import planted_dataset
from dglke_tpu_torch.trainer import evaluate, train

torch.set_num_threads(2)

MRR_GATE, HITS10_GATE = 0.85, 0.99

# tests/test_planted_quality.py:27-46
BASE = dict(hidden_dim=32, gamma=6.0, lr=0.25, batch_size=128,
            neg_sample_size=32, max_step=1500, batch_size_eval=16,
            log_interval=10**9, neg_adversarial_sampling=True,
            regularization_coef=1e-9, seed=7, dataset="synthetic")

CASES = [
    ("TransE_l1", "line", dict(gamma=8.0)),
    ("TransR", "line", dict(hidden_dim=16, lr=0.15)),
    ("RotatE", "line", dict(double_ent=True, lr=0.1)),
    ("DistMult", "cliques", dict(neg_adversarial_sampling=False,
                                 regularization_coef=2e-6, lr=0.15)),
    ("ComplEx", "cycle", dict(neg_adversarial_sampling=False,
                              regularization_coef=2e-6, lr=0.15)),
    ("SimplE", "cycle", dict(neg_adversarial_sampling=False,
                             regularization_coef=2e-6, lr=0.15)),
    ("RESCAL", "cycle", dict(hidden_dim=16, lr=0.1,
                             neg_adversarial_sampling=False)),
]


@pytest.mark.parametrize("model_name,structure,overrides", CASES,
                         ids=[c[0] for c in CASES])
def test_planted_structure_solved(model_name, structure, overrides):
    ds = planted_dataset(structure,
                         n_clusters=8 if structure == "cycle" else 10)
    cfg = KGEConfig(**{**BASE, "model_name": model_name, **overrides})
    quiet = lambda *a: None  # noqa: E731
    model, state, _ = train(cfg, ds, log=quiet, device="cpu")
    m = evaluate(cfg, ds, model, state, "test", log=quiet)
    assert m["MRR"] >= MRR_GATE, (model_name, structure, m)
    assert m["HITS@10"] >= HITS10_GATE, (model_name, structure, m)
