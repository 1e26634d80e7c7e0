"""The training route at step group size 1 on one device, against the JAX
package's: its device pipeline runs only for s > 1 (dglke_tpu/trainer.py:
223), so an odd max_step (s = 1) on a dataset of two batches or more
trains on the host-fed TrainSampler, one batch a step.  The port takes the
same route, logs it with its reason and the sample / update line, draws
the JAX TrainSampler's batches and, from the same tables, ends at the JAX
package's tables.

Tolerances: rtol 1e-5 / atol 1e-6 on tables and Adagrad state (fp32 on
both sides, sums in another order), as in tests/test_torch_async.py.
"""

import numpy as np
import pytest
import torch

import jax

import dglke_tpu.trainer as jax_trainer
import dglke_tpu_torch.trainer as pt_trainer
from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.data.dataset import synthetic_dataset as jax_synthetic
from dglke_tpu.data.sampler import TrainSampler as JaxTrainSampler
from dglke_tpu.models.ke_model import KEModel as JaxModel
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import synthetic_dataset
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.trainer import steps_per_group, train
from dglke_tpu_torch.utils.convert import state_from_numpy

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
N_ENT, N_REL, DIM, B, NEG = 60, 4, 8, 16, 4
DATA = dict(n_entities=N_ENT, n_relations=N_REL, n_train=100, n_valid=5,
            n_test=5, seed=1)
QUIET = lambda *a: None  # noqa: E731


def _cfg(name, steps, **over):
    return dict(model_name=name, hidden_dim=DIM, gamma=4.0, lr=0.25,
                batch_size=B, neg_sample_size=NEG,
                neg_adversarial_sampling=True, regularization_coef=1e-3,
                max_step=steps, log_interval=steps, seed=3, **over)


@pytest.mark.parametrize("name,steps,extra", [
    ("TransE_l2", 7, {}), ("DistMult", 15, {}),
    ("TransE_l2", 9, dict(async_update=True))])
def test_odd_max_step_takes_the_host_fed_route(monkeypatch, name, steps,
                                               extra):
    pds, jds = synthetic_dataset(**DATA), jax_synthetic(**DATA)
    pcfg, jcfg = KGEConfig(**_cfg(name, steps, **extra)), JaxConfig(
        **_cfg(name, steps, **extra))
    assert pds.n_train >= 2 * B
    assert steps_per_group(pcfg, pds.n_train, True, log=QUIET) == 1

    # the batches the port's feed draws, beside the JAX TrainSampler's
    drawn = []

    class Recording(pt_trainer.TrainSampler):
        def __next__(self):
            drawn.append(super().__next__())
            return drawn[-1]

    monkeypatch.setattr(pt_trainer, "TrainSampler", Recording)
    jm = JaxModel(jcfg, N_ENT, N_REL)
    jstate = jax.device_get(jm.init_state(jax.random.PRNGKey(0)))
    pm = KEModel(pcfg, N_ENT, N_REL, device="cpu")
    logs = []
    _, pstate, _ = train(pcfg, pds, model=pm,
                         state=state_from_numpy(jstate, device="cpu"),
                         log=logs.append)
    assert any("host-fed TrainSampler (step group size 1): 1 steps a group"
               in x for x in logs), logs
    assert not any("device-resident pipeline" in x for x in logs)
    assert any(x.startswith("[proc 0]sample: ") and ", update: " in x
               for x in logs)
    assert pstate.step == steps

    want = JaxTrainSampler(jds, B, NEG, seed=jcfg.seed)
    assert len(drawn) >= steps
    for i, got in enumerate(drawn[:steps]):
        jb = next(want)
        assert got["neg_head"] == jb["neg_head"] == (i % 2 == 0)
        for k in ("h", "r", "t", "neg"):
            np.testing.assert_array_equal(got[k], jb[k])

    # the JAX package's own s = 1 route from the same tables
    _, jout, _ = jax_trainer.train(jcfg, jds, model=jm, state=jstate,
                                   log=QUIET)
    jout = jax.device_get(jout)
    for table in ("entity", "relation"):
        for part in ("emb", "state_sum"):
            np.testing.assert_allclose(
                getattr(getattr(pstate, table), part).numpy(),
                np.asarray(getattr(getattr(jout, table), part)),
                rtol=RTOL, atol=ATOL, err_msg=f"{table} {part}")


def test_even_max_step_keeps_the_device_pipeline():
    """An even max_step on the same data (s = 4, what the 100-edge epoch
    holds): the device pipeline, as in the JAX package."""
    cfg = KGEConfig(**_cfg("TransE_l2", 8))
    logs = []
    train(cfg, synthetic_dataset(**DATA), log=logs.append, device="cpu")
    assert any("device-resident pipeline: 4 steps a group" in x
               for x in logs), logs
    assert not any("host-fed" in x for x in logs)
