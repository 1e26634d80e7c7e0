"""--mix_cpu_gpu through dglke_tpu_torch's CLIs on the CPU (the
counterparts of tests/test_cli.py:58-105): host-mode training writes the
standard npy checkpoint with mix_cpu_gpu in its config.json; the eval CLI
of either package adopts host mode from it, and --no_mix_cpu_gpu
evaluates the same checkpoint on device tables with the same metrics;
--init_from resumes host tables; candidate-list datasets are refused
before any step or table load.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (on the CPU: tests/conftest.py)

from dglke_tpu.cli.eval import main as jax_eval_main
from dglke_tpu.cli.train import main as jax_train_main
from dglke_tpu_torch.cli import eval as peval
from dglke_tpu_torch.cli import train as ptrain
from dglke_tpu_torch.data.dataset import KGDataset

torch.set_num_threads(2)

FILES = ["--data_files", "train.txt", "valid.txt", "test.txt"]


@pytest.fixture(scope="module")
def fake_data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fake_udd"))
    rng = np.random.RandomState(0)
    rows = []
    for _ in range(600):
        h = rng.randint(40)
        r = rng.randint(4)
        rows.append(f"e{h}\tr{r}\te{(h + r + 1) % 40}")
    for name, part in (("train", rows[:500]), ("valid", rows[500:550]),
                       ("test", rows[550:])):
        with open(os.path.join(d, f"{name}.txt"), "w") as f:
            f.write("\n".join(part) + "\n")
    return d


def _train_argv(data, save_root, *extra):
    return ["--model_name", "TransE_l2", "--dataset", "fakekg",
            "--data_path", data, "--format", "raw_udd_hrt", *FILES,
            "--batch_size", "64", "--neg_sample_size", "16",
            "--hidden_dim", "16", "--gamma", "5.0", "--lr", "0.3",
            "--max_step", "200", "--log_interval", "100",
            "--batch_size_eval", "8", "-adv", "--save_path", save_root,
            *extra]


def _eval_argv(data, ckpt, *extra):
    return ["--dataset", "fakekg", "--data_path", data,
            "--format", "raw_udd_hrt", *FILES, "--model_path", ckpt,
            "--batch_size_eval", "8", *extra]


def _metrics(out: str):
    return {line.split("average ")[1].split(":")[0]:
            float(line.rsplit(":", 1)[1])
            for line in out.splitlines() if line.startswith("[0]Test average")}


@pytest.fixture(scope="module")
def host_ckpt(fake_data, tmp_path_factory):
    """dglke_tpu_torch-train --mix_cpu_gpu --device cpu --test; returns
    (checkpoint directory, the printed output)."""
    import contextlib
    import io
    save_root = str(tmp_path_factory.mktemp("ckpts"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ptrain.main(_train_argv(fake_data, save_root, "--test",
                                     "--mix_cpu_gpu", "--device", "cpu"))
    assert rc == 0
    return os.path.join(save_root, "TransE_l2_fakekg_0"), out.getvalue()


def test_train_cli_mix_cpu_gpu(host_ckpt):
    ckpt, out = host_ckpt
    assert "NOTE: --mix_cpu_gpu keeps tables in host memory" in out
    assert "host tables: " in out and "wrapped on the CPU" in out
    assert "device-resident pipeline" not in out
    assert set(_metrics(out)) == {"MRR", "MR", "HITS@1", "HITS@3",
                                  "HITS@10"}
    assert os.path.exists(os.path.join(ckpt, "fakekg_TransE_l2_entity.npy"))
    assert int(np.load(os.path.join(ckpt, "fakekg_TransE_l2_step.npy"))) \
        == 200
    with open(os.path.join(ckpt, "config.json")) as f:
        assert json.load(f)["mix_cpu_gpu"] is True


def test_eval_cli_adopts_host_mode_and_no_mix_cpu_gpu_overrides(
        fake_data, host_ckpt, capsys):
    ckpt, train_out = host_ckpt
    assert peval.main(_eval_argv(fake_data, ckpt, "--device", "cpu")) == 0
    out = capsys.readouterr().out
    assert "host-resident tables" in out, out
    host = _metrics(out)
    assert host == _metrics(train_out)
    assert peval.main(_eval_argv(fake_data, ckpt, "--device", "cpu",
                                 "--no_mix_cpu_gpu")) == 0
    out = capsys.readouterr().out
    assert "host-resident tables" not in out, out
    assert _metrics(out) == host


def test_jax_eval_adopts_host_mode_on_the_ports_checkpoint(
        fake_data, host_ckpt, capsys):
    """The JAX package's eval CLI reads the port's host checkpoint, takes
    its host path from config.json, and ranks it the same."""
    ckpt, train_out = host_ckpt
    assert jax_eval_main(_eval_argv(fake_data, ckpt)) == 0
    out = capsys.readouterr().out
    assert "host-resident tables" in out, out
    assert _metrics(out) == pytest.approx(_metrics(train_out), rel=1e-12)


def test_port_eval_adopts_host_mode_on_a_jax_checkpoint(fake_data, tmp_path,
                                                        capsys):
    save_root = str(tmp_path / "jax_ckpts")
    assert jax_train_main(_train_argv(fake_data, save_root,
                                      "--mix_cpu_gpu")) == 0
    capsys.readouterr()
    ckpt = os.path.join(save_root, "TransE_l2_fakekg_0")
    assert jax_eval_main(_eval_argv(fake_data, ckpt)) == 0
    want = _metrics(capsys.readouterr().out)
    assert peval.main(_eval_argv(fake_data, ckpt, "--device", "cpu")) == 0
    out = capsys.readouterr().out
    assert "host-resident tables" in out, out
    assert _metrics(out) == pytest.approx(want, rel=1e-12)


def test_eval_cli_mix_cpu_gpu_on_a_device_checkpoint(fake_data, tmp_path,
                                                     capsys):
    """--mix_cpu_gpu takes host mode on a checkpoint trained on the
    device, with the device path's metrics."""
    save_root = str(tmp_path / "ckpts")
    assert ptrain.main(_train_argv(fake_data, save_root, "--device",
                                   "cpu")) == 0
    ckpt = os.path.join(save_root, "TransE_l2_fakekg_0")
    capsys.readouterr()
    assert peval.main(_eval_argv(fake_data, ckpt, "--device", "cpu")) == 0
    out = capsys.readouterr().out
    assert "host-resident tables" not in out
    want = _metrics(out)
    assert peval.main(_eval_argv(fake_data, ckpt, "--device", "cpu",
                                 "--mix_cpu_gpu")) == 0
    out = capsys.readouterr().out
    assert "host-resident tables" in out
    assert _metrics(out) == want


def test_init_from_resumes_host_tables(fake_data, host_ckpt, tmp_path,
                                       monkeypatch, capsys):
    """--init_from with --mix_cpu_gpu reads the npy files into host tables
    (load_host_state, never the device loader) and trains on from the
    saved step."""
    ckpt, _ = host_ckpt
    monkeypatch.setattr(ptrain, "load_model_state", None)  # must not run
    save_root = str(tmp_path / "resumed")
    assert ptrain.main(_train_argv(
        fake_data, save_root, "--mix_cpu_gpu", "--device", "cpu",
        "--init_from", ckpt, "--max_step", "50", "--log_interval",
        "50")) == 0
    out = capsys.readouterr().out
    assert f"Resumed from {ckpt} at step 200" in out
    assert "bytes drawn" not in out      # no fresh init
    assert "host tables: each step eagerly on the CPU" in out
    step = np.load(os.path.join(save_root, "TransE_l2_fakekg_0",
                                "fakekg_TransE_l2_step.npy"))
    assert int(step) == 250


def _candidate_dataset(**dicts):
    cand = {"h,r->t": {"hr": np.zeros((2, 2), np.int32),
                       "t_candidate": np.zeros((2, 3), np.int32),
                       "t_correct_index": np.zeros(2, np.int32)}}
    n = 200
    return KGDataset(
        name="wikikg90M", n_entities=40, n_relations=4,
        train=(np.arange(n) % 40, np.arange(n) % 4, (np.arange(n) + 1) % 40),
        **{k: cand for k in dicts})


@pytest.mark.parametrize("flag,split", [("--valid", "valid_dict"),
                                        ("--test", "test_dict")])
def test_train_cli_refuses_candidate_eval_before_step_one(
        monkeypatch, tmp_path, flag, split):
    monkeypatch.setattr(ptrain, "get_dataset",
                        lambda *a, **k: _candidate_dataset(**{split: 1}))
    monkeypatch.setattr(ptrain, "train", None)     # step 1 never comes
    with pytest.raises(SystemExit, match="cannot evaluate candidate-list"):
        ptrain.main(["--dataset", "wikikg90M", "--data_path",
                     str(tmp_path), "--mix_cpu_gpu", "--device", "cpu",
                     "--save_path", str(tmp_path), flag])


def test_eval_cli_refuses_candidate_eval_before_loading(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(peval, "get_dataset",
                        lambda *a, **k: _candidate_dataset(test_dict=1))
    monkeypatch.setattr(peval, "load_host_state", None)   # never loads
    with pytest.raises(SystemExit, match="cannot evaluate candidate-list"):
        peval.main(["--dataset", "wikikg90M", "--data_path", str(tmp_path),
                    "--model_path", str(tmp_path), "--mix_cpu_gpu",
                    "--device", "cpu"])
