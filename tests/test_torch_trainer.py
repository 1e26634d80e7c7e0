"""dglke_tpu_torch's trainer, pipeline, checkpoints and CLI on the CPU.

Per-run parity with the JAX package is statistical (the two frameworks'
random streams differ): the planted TransE_l2 gate of
tests/test_planted_quality.py must pass through the port's own train()
and evaluate().  Checkpoints are exact: either package reads the other's,
and both rank a checkpoint identically.
"""

import os

import numpy as np
import pytest
import torch

from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.data.dataset import get_dataset as jax_get_dataset
from dglke_tpu.models.ke_model import KEModel as JaxModel
from dglke_tpu.trainer import evaluate as jax_evaluate
from dglke_tpu.utils import io as jax_io
from dglke_tpu_torch.cli.eval import main as eval_main
from dglke_tpu_torch.cli.train import main as train_main
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import (
    KGDataset,
    get_dataset,
    planted_dataset,
    synthetic_dataset,
)
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.models.score_functions import make_score_function
from dglke_tpu_torch.trainer import DevicePipeline, evaluate, train
from dglke_tpu_torch.utils import io as pt_io

torch.set_num_threads(2)

QUIET = lambda *a: None  # noqa: E731

# tests/test_planted_quality.py's TransE_l2 case
PLANTED = dict(hidden_dim=32, gamma=4.0, lr=0.25, batch_size=128,
               neg_sample_size=32, max_step=2000, batch_size_eval=16,
               log_interval=10**9, neg_adversarial_sampling=True,
               regularization_coef=1e-9, seed=7, dataset="synthetic",
               model_name="TransE_l2")


def test_planted_transe_l2_gate():
    ds = planted_dataset("line", n_clusters=10)
    cfg = KGEConfig(**PLANTED)
    model, state, _ = train(cfg, ds, log=QUIET, device="cpu")
    assert state.step == cfg.max_step
    m = evaluate(cfg, ds, model, state, "test", log=QUIET)
    assert m["MRR"] >= 0.85, m
    assert m["HITS@10"] >= 0.99, m


def _small_run(seed):
    ds = synthetic_dataset(n_entities=200, n_relations=10, n_train=2000,
                           n_valid=50, n_test=50, seed=0)
    cfg = KGEConfig(model_name="TransE_l2", hidden_dim=16, gamma=6.0,
                    lr=0.2, batch_size=64, neg_sample_size=16, max_step=30,
                    log_interval=10, neg_adversarial_sampling=True,
                    seed=seed)
    logs = []
    model, state, _ = train(cfg, ds, log=logs.append, device="cpu")
    return model, state, logs


def test_training_is_bit_reproducible():
    _, s1, logs1 = _small_run(seed=3)
    _, s2, logs2 = _small_run(seed=3)
    _, s3, _ = _small_run(seed=4)
    assert torch.equal(s1.entity.emb, s2.entity.emb)
    assert torch.equal(s1.relation.emb, s2.relation.emb)
    assert torch.equal(s1.entity.state_sum, s2.entity.state_sum)
    assert [x for x in logs1 if "average" in x] == \
        [x for x in logs2 if "average" in x]
    assert not torch.equal(s1.entity.emb, s3.entity.emb)
    assert sum("average loss" in x for x in logs1) == 3


def test_device_pipeline_epochs_straddle_and_sides_alternate():
    """10 edges, batches of 4: five steps cover two exact epochs, the
    batches at the boundaries straddle them, and no edge repeats inside
    an epoch."""
    n = 10
    ds = KGDataset(name="ids", n_entities=40, n_relations=1,
                   train=(np.arange(n), np.zeros(n, np.int64),
                          np.arange(n) + 20,
                          np.arange(n, dtype=np.float32) + 1.0))
    cfg = KGEConfig(hidden_dim=8, batch_size=4, neg_sample_size=2)
    model = KEModel(cfg, ds.n_entities, ds.n_relations, device="cpu")
    pipe = DevicePipeline(model, ds, 4, 4, seed=1)
    heads, sides, negs = [], [], []
    for _ in range(5):
        h, r, t, neg, impts, neg_head = pipe.next_batch()
        assert torch.equal(t, h + 20) and not r.any()
        assert torch.equal(impts, h.float() + 1.0)
        assert neg.dtype == torch.int32 and neg.shape == (4,)
        assert 0 <= int(neg.min()) and int(neg.max()) < 40
        heads.append(h)
        sides.append(neg_head)
        negs.append(neg)
    flat = torch.cat(heads).tolist()
    assert sorted(flat[:n]) == list(range(n))
    assert sorted(flat[n:]) == list(range(n))
    assert flat[:n] != flat[n:]          # a fresh permutation per epoch
    assert sides == [True, False, True, False, True]
    assert len({tuple(x.tolist()) for x in negs}) > 1
    assert pipe.epoch == 2


@pytest.fixture(scope="module")
def raw_udd(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("raw_udd"))
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


def _cli(data, save_root, *extra):
    return ["--model_name", "TransE_l2", "--dataset", "fakekg",
            "--data_path", data, "--format", "raw_udd_hrt",
            "--data_files", "train.txt", "valid.txt", "test.txt",
            "--batch_size", "64", "--neg_sample_size", "16",
            "--hidden_dim", "16", "--gamma", "5.0", "--lr", "0.3",
            "--max_step", "100", "--log_interval", "50",
            "--batch_size_eval", "8", "-adv", "--save_path", save_root,
            *extra]


def _metrics(out: str):
    return {line.split("average ")[1].split(":")[0]:
            float(line.rsplit(":", 1)[1])
            for line in out.splitlines() if line.startswith("[0]Test average")}


def test_cli_checkpoint_reads_in_jax_with_the_same_metrics(raw_udd, tmp_path,
                                                            capsys):
    save_root = str(tmp_path / "ckpts")
    assert train_main(_cli(raw_udd, save_root, "--device", "cpu",
                           "--test")) == 0
    printed = _metrics(capsys.readouterr().out)
    assert set(printed) == {"MRR", "MR", "HITS@1", "HITS@3", "HITS@10"}
    ckpt = os.path.join(save_root, "TransE_l2_fakekg_0")

    jcfg = jax_io.load_config(ckpt)
    jds = jax_get_dataset(raw_udd, "fakekg", "raw_udd_hrt", "\t",
                          ["train.txt", "valid.txt", "test.txt"])
    jm = JaxModel(jcfg, jds.n_entities, jds.n_relations)
    jstate = jax_io.load_model_state(jcfg, jm, ckpt)
    assert int(jstate.step) == 100
    want = jax_evaluate(jcfg, jds, jm, jstate, "test", log=QUIET)

    pcfg = pt_io.load_config(ckpt)
    pds = get_dataset(raw_udd, "fakekg", "raw_udd_hrt", "\t",
                      ["train.txt", "valid.txt", "test.txt"])
    pm = KEModel(pcfg, pds.n_entities, pds.n_relations, device="cpu")
    pstate = pt_io.load_model_state(pcfg, pm, ckpt)
    np.testing.assert_array_equal(pstate.entity.emb.numpy(),
                                  np.asarray(jstate.entity.emb))
    got = evaluate(pcfg, pds, pm, pstate, "test", log=QUIET)
    assert got == want
    assert printed == pytest.approx(got, rel=1e-12)

    assert eval_main(["--data_path", raw_udd, "--format", "raw_udd_hrt",
                      "--data_files", "train.txt", "valid.txt", "test.txt",
                      "--model_path", ckpt, "--batch_size_eval", "8",
                      "--device", "cpu"]) == 0
    assert _metrics(capsys.readouterr().out) == pytest.approx(got,
                                                              rel=1e-12)


def test_jax_checkpoint_reads_in_the_port(tmp_path):
    import jax
    jcfg = JaxConfig(model_name="TransE_l2", hidden_dim=8, dataset="kg",
                     save_path=str(tmp_path))
    jm = JaxModel(jcfg, 30, 3)
    jstate = jm.init_state(jax.random.PRNGKey(0))
    jax_io.save_model(jcfg, jm, jstate)
    pcfg = pt_io.load_config(str(tmp_path))
    assert (pcfg.model_name, pcfg.hidden_dim) == ("TransE_l2", 8)
    pm = KEModel(pcfg, 30, 3, device="cpu")
    pstate = pt_io.load_model_state(pcfg, pm, str(tmp_path))
    np.testing.assert_array_equal(pstate.entity.emb.numpy(),
                                  np.asarray(jstate.entity.emb))
    np.testing.assert_array_equal(pstate.relation.emb.numpy(),
                                  np.asarray(jstate.relation.emb))
    assert pstate.step == 0


def test_bf16_checkpoint_round_trip(tmp_path):
    cfg = KGEConfig(model_name="TransE_l2", hidden_dim=8, dataset="kg",
                    emb_dtype="bfloat16", save_path=str(tmp_path))
    model = KEModel(cfg, 30, 3, device="cpu")
    state = model.init_state()
    state.step = 7
    pt_io.save_model(cfg, model, state)
    back = pt_io.load_model_state(cfg, model, str(tmp_path))
    assert back.entity.emb.dtype == torch.bfloat16
    assert torch.equal(back.entity.emb, state.entity.emb)
    assert back.step == 7


# The modes the port does not run yet are refused with their ROADMAP item;
# --async_update, sampled eval (--neg_sample_size_eval), host-resident
# tables (--mix_cpu_gpu), --dist and --sharded_ckpt, ported since, are
# accepted and run (--dist here as one rank of a gloo group on the CPU).
PORTED = {"--async_update", "--neg_sample_size_eval", "--mix_cpu_gpu",
          "--dist", "--sharded_ckpt"}


@pytest.mark.parametrize("flags", [
    ["--dist"], ["--mix_cpu_gpu"], ["--async_update"], ["--sharded_ckpt"],
    ["--neg_sample_size_eval", "10"]], ids=lambda f: f[0].lstrip("-"))
def test_cli_refuses_unported_modes(raw_udd, tmp_path, flags, capsys,
                                    monkeypatch):
    import socket
    argv = _cli(raw_udd, str(tmp_path), "--device", "cpu", "--test", *flags)
    if flags[0] == "--dist":
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", port),
                     ("RANK", 0), ("WORLD_SIZE", 1)):
            monkeypatch.setenv(k, str(v))
    if flags[0] not in PORTED:
        with pytest.raises(SystemExit, match="ROADMAP item"):
            train_main(argv)
        return
    assert train_main(argv) == 0
    assert set(_metrics(capsys.readouterr().out)) == {
        "MRR", "MR", "HITS@1", "HITS@3", "HITS@10"}


def test_eval_cli_refuses_sampled_eval(raw_udd, tmp_path):
    """Sampled eval runs through the eval CLI now; what it still refuses,
    as the JAX package does, is degree-sampled eval negatives with the
    positive-edge filter on."""
    with pytest.raises(ValueError, match="requires --no_eval_filter"):
        eval_main(["--data_path", raw_udd, "--format", "raw_udd_hrt",
                   "--data_files", "train.txt", "valid.txt", "test.txt",
                   "--model_path", str(tmp_path), "--device", "cpu",
                   "--neg_sample_size_eval", "10", "--neg_deg_sample_eval"])


def test_unknown_model_name_raises():
    with pytest.raises(ValueError, match="unknown model TransQ"):
        make_score_function("TransQ", 12.0, 16)
