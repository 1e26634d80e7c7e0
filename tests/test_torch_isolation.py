"""dglke_tpu_torch stands alone: it imports neither JAX nor the JAX
package, its entry points run on the CUDA device unless asked for the CPU
(and raise without one), and its kernel module works on the CPU without
the CUDA toolkit."""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import dglke_tpu_torch
from dglke_tpu_torch import device as pt_device
from dglke_tpu_torch import trainer as pt_trainer
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import synthetic_dataset
from dglke_tpu_torch.host_table import train_host
from dglke_tpu_torch.models.infer import EmbSimInfer, InferModel
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.ops import outer_update, rows, transe_l2
from dglke_tpu_torch.ops.embedding import EmbeddingState
from dglke_tpu_torch.parallel.mesh import init_distributed
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


def _native_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".cu", ".cuh", ".cpp")):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(_native_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_native_sources_stand_alone(path):
    """Every C++ / CUDA source of the port includes only system headers
    and files beside it: nothing of the JAX package's native/."""
    import re
    here = os.path.dirname(path)
    for line in open(path):
        m = re.match(r'\s*#\s*include\s*"([^"]+)"', line)
        if m:
            assert os.path.exists(os.path.join(here, m.group(1))) and \
                "/" not in m.group(1), (path, line)
    from dglke_tpu_torch.data import native
    assert str(native.SOURCE).startswith(PKG)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cfg():
    return KGEConfig(hidden_dim=8, batch_size=16, neg_sample_size=4,
                     max_step=2, log_interval=1)


def _ds():
    return synthetic_dataset(n_entities=50, n_relations=4, n_train=200,
                             n_valid=10, n_test=10)


_DIST_ENV = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1", "RANK": "0",
             "WORLD_SIZE": "2"}


def _state_arrays():
    from dglke_tpu_torch.utils.convert import NumpyState, NumpyTable
    t = NumpyTable(np.zeros((5, 4), np.float32), np.zeros(5, np.float32))
    return NumpyState(t, t, np.asarray(0, np.int32))


ENTRY_POINTS = {
    "resolve_device": lambda: pt_device.resolve_device(),
    "KEModel": lambda: KEModel(_cfg(), 50, 4),
    "train": lambda: pt_trainer.train(_cfg(), _ds(), log=lambda *a: None),
    # host-resident tables have no CPU fallback either
    "train --mix_cpu_gpu": lambda: pt_trainer.train(
        dataclasses.replace(_cfg(), mix_cpu_gpu=True), _ds(),
        log=lambda *a: None),
    "train_host": lambda: train_host(_cfg(), _ds(), log=lambda *a: None),
    "state_from_numpy": lambda: state_from_numpy(_state_arrays()),
    # the JAX package's gpu id -1 selects the card all the same
    "InferModel": lambda: InferModel(_cfg(), device=-1),
    "EmbSimInfer": lambda: EmbSimInfer(-1, "entity.npy"),
    # a --dist rank: its device is a card unless the CPU is asked for
    "rank_device": lambda: pt_device.rank_device(None, local_rank=1),
    "init_distributed": lambda: init_distributed(environ=_DIST_ENV),
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
    assert pt_device.rank_device("cpu", local_rank=3).type == "cpu"


def test_dist_layout_is_chosen_without_fallback(monkeypatch):
    """The backend follows from the layout: the CPU takes gloo; ranks on
    cards of their own NCCL, ranks sharing a card gloo (host-staged);
    the rank's card is cuda:{LOCAL_RANK % device_count}."""
    from dglke_tpu_torch.parallel import mesh
    assert mesh.choose_layout("cpu", 0, 2)[1] == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    dev, backend, layout = mesh.choose_layout("cuda", 1, 2)
    assert (str(dev), backend, layout) == ("cuda:1", "nccl",
                                           "one card a rank")
    dev, backend, layout = mesh.choose_layout("cuda", 3, 4)
    assert (str(dev), backend, layout) == ("cuda:1", "gloo",
                                           "2 ranks share cuda:1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.choose_layout("cuda", 1, 2)[1:] == (
        "gloo", "2 ranks share cuda:0")
    with pytest.raises(SystemExit, match="MASTER_PORT, RANK"):
        mesh.DistEnv.from_environ({"MASTER_ADDR": "h", "WORLD_SIZE": "2"})
    env = mesh.DistEnv.from_environ(dict(_DIST_ENV, LOCAL_RANK="1"))
    assert (env.rank, env.world, env.local_rank, env.local_world) == (
        0, 2, 1, 2)


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
    for source in (rows.SOURCE, outer_update.SOURCE, transe_l2.SOURCE):
        assert os.path.isfile(source)
        assert source.suffix == ".cu"
        assert source.parent == rows.CSRC
