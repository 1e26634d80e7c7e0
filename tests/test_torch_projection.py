"""TransR's projection table across the two packages: a JAX TrainState
carried into the port and back, and checkpoints written by either package
and read by the other, with identical tables and identical filtered
metrics."""

import os

import numpy as np
import torch

import jax

from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.data.dataset import KGDataset as JaxDataset
from dglke_tpu.models.ke_model import KEModel as JaxModel
from dglke_tpu.trainer import evaluate as jax_evaluate
from dglke_tpu.utils import io as jax_io
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import KGDataset
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.trainer import evaluate
from dglke_tpu_torch.utils import io as pt_io
from dglke_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

N_ENT, N_REL, DIM = 40, 3, 8
KW = dict(model_name="TransR", hidden_dim=DIM, gamma=4.0, dataset="kg",
          batch_size_eval=8)
QUIET = lambda *a: None  # noqa: E731


def _data():
    rng = np.random.default_rng(0)

    def triples(n):
        return (rng.integers(0, N_ENT, n), rng.integers(0, N_REL, n),
                rng.integers(0, N_ENT, n))

    kw = dict(name="kg", n_entities=N_ENT, n_relations=N_REL,
              train=triples(200), test=triples(20))
    return JaxDataset(**kw), KGDataset(**kw)


def _assert_tables_equal(pstate, jstate):
    for name in ("entity", "relation", "projection"):
        p, j = getattr(pstate, name), getattr(jstate, name)
        np.testing.assert_array_equal(p.emb.numpy(), np.asarray(j.emb))
        np.testing.assert_array_equal(p.state_sum.numpy(),
                                      np.asarray(j.state_sum))
    assert pstate.step == int(jstate.step)


def test_jax_transr_state_round_trips_through_the_port():
    jm = JaxModel(JaxConfig(**KW), N_ENT, N_REL)
    jstate = jax.device_get(jm.init_state(jax.random.PRNGKey(1)))
    pstate = state_from_numpy(jstate, device="cpu")
    _assert_tables_equal(pstate, jstate)
    back = state_to_numpy(pstate)
    assert back.projection.emb.shape == (N_REL, DIM * DIM)
    for name in ("entity", "relation", "projection"):
        np.testing.assert_array_equal(getattr(back, name).emb,
                                      getattr(jstate, name).emb)
        np.testing.assert_array_equal(getattr(back, name).state_sum,
                                      getattr(jstate, name).state_sum)


def test_port_transr_checkpoint_reads_in_jax(tmp_path):
    jds, pds = _data()
    pcfg = KGEConfig(**KW, save_path=str(tmp_path))
    pm = KEModel(pcfg, N_ENT, N_REL, device="cpu")
    pstate = pm.init_state()
    pstate.projection.state_sum += 0.5
    pstate.step = 9
    pt_io.save_model(pcfg, pm, pstate)
    assert os.path.isfile(tmp_path / "kg_TransRprojection.npy")
    assert os.path.isfile(tmp_path / "kg_TransR_projection_state.npy")

    jcfg = jax_io.load_config(str(tmp_path))
    jm = JaxModel(jcfg, N_ENT, N_REL)
    jstate = jax_io.load_model_state(jcfg, jm, str(tmp_path))
    _assert_tables_equal(pstate, jstate)
    assert (evaluate(pcfg, pds, pm, pstate, "test", log=QUIET)
            == jax_evaluate(jcfg, jds, jm, jstate, "test", log=QUIET))


def test_jax_transr_checkpoint_reads_in_the_port(tmp_path):
    jds, pds = _data()
    jcfg = JaxConfig(**KW, save_path=str(tmp_path))
    jm = JaxModel(jcfg, N_ENT, N_REL)
    jstate = jm.init_state(jax.random.PRNGKey(2))
    jax_io.save_model(jcfg, jm, jstate)

    pcfg = pt_io.load_config(str(tmp_path))
    pm = KEModel(pcfg, N_ENT, N_REL, device="cpu")
    pstate = pt_io.load_model_state(pcfg, pm, str(tmp_path))
    _assert_tables_equal(pstate, jstate)
    assert (evaluate(pcfg, pds, pm, pstate, "test", log=QUIET)
            == jax_evaluate(jcfg, jds, jm, jstate, "test", log=QUIET))


def test_projection_is_read_under_the_underscore_spelling(tmp_path):
    cfg = KGEConfig(**KW, save_path=str(tmp_path))
    model = KEModel(cfg, N_ENT, N_REL, device="cpu")
    state = model.init_state()
    pt_io.save_model(cfg, model, state)
    os.replace(tmp_path / "kg_TransRprojection.npy",
               tmp_path / "kg_TransR_projection.npy")
    back = pt_io.load_model_state(cfg, model, str(tmp_path))
    assert torch.equal(back.projection.emb, state.projection.emb)
