"""dglke_tpu_torch stands alone: it imports neither JAX nor the JAX
package, its entry points run on the CUDA device unless asked for the CPU
(and raise without one), and its kernel module works on the CPU without
the CUDA toolkit."""

import ast
import os

import numpy as np
import pytest
import torch

import dglke_tpu_torch
from dglke_tpu_torch import device as pt_device
from dglke_tpu_torch import trainer as pt_trainer
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import synthetic_dataset
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.ops import outer_update, rows
from dglke_tpu_torch.ops.embedding import EmbeddingState
from dglke_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(dglke_tpu_torch.__file__)


def _port_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "dglke_tpu")


@pytest.mark.parametrize("path", sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_dglke_tpu_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cfg():
    return KGEConfig(hidden_dim=8, batch_size=16, neg_sample_size=4,
                     max_step=2, log_interval=1)


def _ds():
    return synthetic_dataset(n_entities=50, n_relations=4, n_train=200,
                             n_valid=10, n_test=10)


def _state_arrays():
    from dglke_tpu_torch.utils.convert import NumpyState, NumpyTable
    t = NumpyTable(np.zeros((5, 4), np.float32), np.zeros(5, np.float32))
    return NumpyState(t, t, np.asarray(0, np.int32))


ENTRY_POINTS = {
    "resolve_device": lambda: pt_device.resolve_device(),
    "KEModel": lambda: KEModel(_cfg(), 50, 4),
    "train": lambda: pt_trainer.train(_cfg(), _ds(), log=lambda *a: None),
    "state_from_numpy": lambda: state_from_numpy(_state_arrays()),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card_and_raise_without_one(no_gpu,
                                                                entry):
    with pytest.raises(RuntimeError, match="CUDA device"):
        ENTRY_POINTS[entry]()


def test_cli_defaults_to_the_card(no_gpu, tmp_path):
    from dglke_tpu_torch.cli.train import main
    d = tmp_path / "d"
    d.mkdir()
    for name in ("train", "valid", "test"):
        (d / f"{name}.txt").write_text("a\tr\tb\nb\tr\tc\n")
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["--dataset", "kg", "--data_path", str(d), "--format",
              "raw_udd_hrt", "--data_files", "train.txt", "valid.txt",
              "test.txt", "--save_path", str(tmp_path / "ck")])


def test_entry_points_run_on_the_cpu_when_asked(no_gpu):
    model = KEModel(_cfg(), 50, 4, device="cpu")
    assert model.device.type == "cpu"
    state = state_from_numpy(_state_arrays(), device="cpu")
    assert state_to_numpy(state).entity.emb.shape == (5, 4)


def test_kernel_module_runs_on_the_cpu_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(rows.shutil, "which", lambda name: None)
    monkeypatch.setattr(rows.os.path, "exists", lambda p: False)
    monkeypatch.setattr(rows, "_libs", {})
    table = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    ids = torch.tensor([5, 0, 5], dtype=torch.int32)
    assert torch.equal(rows.gather_rows(table, ids), table[[5, 0, 5]])
    ss = torch.zeros(6)
    rows.sparse_adagrad_rows(table, ss, ids, torch.ones((3, 4)), 0.5)
    assert float(ss[5]) == 2.0 and float(ss[0]) == 1.0
    outer_update.outer_adagrad_update(
        EmbeddingState(table, ss), ids, torch.ones((3, 2)),
        torch.ones((3, 2)), 0.5)
    assert float(ss[5]) == 4.0 and float(ss[0]) == 2.0
    assert rows._libs == {}             # nothing was built or loaded
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rows._nvcc()


def test_kernel_sources_ship_with_the_package():
    for source in (rows.SOURCE, outer_update.SOURCE):
        assert os.path.isfile(source)
        assert source.suffix == ".cu"
        assert source.parent == rows.CSRC
