"""dglke_tpu_torch-train / -eval --dist end to end on 2 ranks (gloo,
--device cpu), on the planted 'line' graph of
tests/test_planted_quality.py (60 entities: a vocab shard of 30 rows).

  * the planted gate (MRR >= 0.85, HITS@10 >= 0.99) under each plan, the
    metrics equal on every rank (vocab: the same batches on every rank;
    replicated: strided, partial sums combined), the edges split in
    place (replicated with --rel_part);
  * without --sharded_ckpt the npy checkpoint written through rank 0
    equals the concatenated, unpadded shards of a --sharded_ckpt run of
    the same seed, and one device's dglke_tpu_torch-eval and the JAX
    package's dglke_tpu-eval read it and give the metrics of the run;
  * --sharded_ckpt with --save_interval, resumed with --init_from on 2
    ranks: the step counter goes on, and a resume of 0 steps saves files
    bit-equal to those it read; -eval --dist reads the sharded checkpoint
    and gives the run's metrics; one rank is refused (train and eval), and
    so is the JAX package's sharded format;
  * --partition_path with the dglke_tpu_torch-partition artifacts.
"""

import json
import os
import re
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_util import (  # noqa: E402
    cli_argv,
    start_ranks,
    wait_ranks,
)

W = 2
TRAIN = "dglke_tpu_torch.cli.train"
EVAL = "dglke_tpu_torch.cli.eval"
FILES = ["entities.tsv", "relations.tsv", "train.tsv", "valid.tsv",
         "test.tsv"]
# tests/test_planted_quality.py's TransE_l2 case (batch_size is per rank:
# 2 x 128 rows a step), 600 steps
RECIPE = ["--model_name", "TransE_l2", "--hidden_dim", "32", "--gamma",
          "4.0", "--lr", "0.25", "--batch_size", "128",
          "--neg_sample_size", "32", "--batch_size_eval", "16",
          "--log_interval", "300", "-adv", "-rc", "1e-9", "--seed", "7"]
STEPS = 600
METRIC = re.compile(r"\[(\d)\]Test average (\S+): (\S+)")


def _data_args(root):
    return ["--dataset", "planted", "--data_path", os.path.join(root, "d"),
            "--format", "udd_hrt", "--data_files", *FILES]


def _metrics(outputs):
    """Each rank's printed test metrics ({name: value}, from the lines of
    its own index)."""
    per_rank = []
    for rank, (rc, so, se) in enumerate(outputs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{so[-2000:]}{se[-3000:]}"
        per_rank.append({k: float(v) for r, k, v in METRIC.findall(so)
                         if int(r) == rank})
    return per_rank


def _train_argv(root, name, *extra, steps=STEPS):
    return cli_argv(TRAIN, [*_data_args(root), *RECIPE, "--max_step",
                            str(steps), "--save_path",
                            os.path.join(root, name), *extra])


def _together(runs: dict) -> dict:
    """Run every {name: argv_of} at once, 2 ranks each; their outputs."""
    procs = {k: start_ranks(v, W) for k, v in runs.items()}
    return {k: wait_ranks(p) for k, p in procs.items()}


def _ckpt(root, name):
    return os.path.join(root, name, "TransE_l2_planted_0")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from dglke_tpu_torch.data.dataset import planted_dataset
    root = str(tmp_path_factory.mktemp("dist_cli"))
    ds = planted_dataset("line", n_clusters=10)
    d = os.path.join(root, "d")
    os.makedirs(d)
    with open(os.path.join(d, "entities.tsv"), "w") as f:
        f.writelines(f"{i}\te{i}\n" for i in range(ds.n_entities))
    with open(os.path.join(d, "relations.tsv"), "w") as f:
        f.writelines(f"{i}\tr{i}\n" for i in range(ds.n_relations))
    for split, tri in (("train", ds.train), ("valid", ds.test),
                       ("test", ds.test)):
        np.savetxt(os.path.join(d, f"{split}.tsv"),
                   np.stack(tri[:3], axis=1), fmt="%d", delimiter="\t")
    out = _together({
        "vocab": _train_argv(root, "vocab", "--table_sharding", "vocab",
                             "--test"),
        "sharded": _train_argv(root, "sharded", "--table_sharding", "vocab",
                               "--sharded_ckpt", "--save_interval", "300"),
        "replicated": _train_argv(root, "replicated", "--table_sharding",
                                  "replicated", "--rel_part", "--test",
                                  "--no_save_emb")})
    out.update(_together({
        "resume0": _train_argv(root, "resume0", "--table_sharding", "vocab",
                               "--sharded_ckpt", "--init_from",
                               _ckpt(root, "sharded"), steps=0),
        "resume": _train_argv(root, "resume", "--table_sharding", "vocab",
                              "--sharded_ckpt", "--init_from",
                              _ckpt(root, "sharded"), steps=20),
        "eval": cli_argv(EVAL, [*_data_args(root), "--batch_size_eval",
                                "16", "--model_path",
                                _ckpt(root, "sharded")])}))
    return root, ds, out


@pytest.mark.parametrize("plan", ["vocab", "replicated"])
def test_planted_gate_holds_on_every_rank(runs, plan):
    _, _, out = runs
    m = _metrics(out[plan])
    assert m[0] == m[1] and set(m[0]) == {"MRR", "MR", "HITS@1", "HITS@3",
                                          "HITS@10"}
    assert m[0]["MRR"] >= 0.85 and m[0]["HITS@10"] >= 0.99, m[0]
    so0 = out[plan][0][1]
    assert f"Using 2-rank mesh (tables: {plan}; backend gloo: 2 rank(s) " \
           f"on the CPU)" in so0
    assert f"[proc 0][Train]({STEPS}/{STEPS}) average loss" in so0
    # logs on rank 0 only; each rank trains on about half of the edges
    assert "[Train]" not in out[plan][1][1]
    sizes = [int(re.search(r"\|Train\|: (\d+)", o[1]).group(1))
             for o in out[plan]]
    assert sum(sizes) == 735 and min(sizes) >= 128


def test_npy_save_equals_the_concatenated_shards(runs):
    root, ds, _ = runs
    npy = _ckpt(root, "vocab")
    shards = os.path.join(_ckpt(root, "sharded"), "sharded_state")
    layout = json.load(open(os.path.join(shards, "layout.json")))
    assert layout["world_size"] == 2 and layout["rows_per_rank"] == 30
    for table, want_rows in (("entity", ds.n_entities),
                             ("entity_state", ds.n_entities)):
        got = np.load(os.path.join(npy, f"planted_TransE_l2_{table}.npy"))
        parts = [np.load(os.path.join(shards, f"rank_{r}", f"{table}.npy"))
                 for r in range(W)]
        assert got.shape[0] == want_rows
        np.testing.assert_array_equal(got, np.concatenate(parts))
    for table in ("relation", "relation_state", "step"):
        np.testing.assert_array_equal(
            np.load(os.path.join(npy, f"planted_TransE_l2_{table}.npy")),
            np.load(os.path.join(shards, "rank_0", f"{table}.npy")))
    assert int(np.load(os.path.join(npy, "planted_TransE_l2_step.npy"))) \
        == STEPS
    cfg = json.load(open(os.path.join(_ckpt(root, "sharded"),
                                      "config.json")))
    assert (cfg["ckpt_table_sharding"], cfg["ckpt_mesh_size"]) == ("vocab",
                                                                   2)


def _eval_argv(root, path):
    return [*_data_args(root), "--batch_size_eval", "16", "--model_path",
            path]


def test_one_device_and_jax_eval_read_the_npy_save(runs, capsys):
    root, _, out = runs
    want = _metrics(out["vocab"])[0]
    from dglke_tpu.cli import eval as jeval
    from dglke_tpu_torch.cli import eval as peval
    capsys.readouterr()
    assert peval.main([*_eval_argv(root, _ckpt(root, "vocab")),
                       "--device", "cpu"]) == 0
    assert jeval.main(_eval_argv(root, _ckpt(root, "vocab"))) == 0
    text = capsys.readouterr().out
    got = [float(v) for r, k, v in METRIC.findall(text) if k == "MRR"]
    assert len(got) == 2
    # the port's ranks are identical; the JAX package scores the same
    # tables with its own rounding
    assert got[0] == want["MRR"]
    assert abs(got[1] - want["MRR"]) < 1e-6


def _files(path):
    out = {}
    for dirpath, _, files in os.walk(path):
        for f in files:
            if f.endswith(".npy"):
                rel = os.path.relpath(os.path.join(dirpath, f), path)
                out[rel] = open(os.path.join(dirpath, f), "rb").read()
    return out


def test_sharded_resume_is_bit_equal_and_goes_on(runs):
    root, _, out = runs
    for rank, (rc, so, se) in enumerate(out["resume0"] + out["resume"]):
        assert rc == 0, se[-3000:]
        assert f"Resumed from {_ckpt(root, 'sharded')} at step {STEPS}" in so
    saved = _files(os.path.join(_ckpt(root, "sharded"), "sharded_state"))
    again = _files(os.path.join(_ckpt(root, "resume0"), "sharded_state"))
    assert set(saved) == set(again) and len(saved) == 7
    for k in saved:
        assert saved[k] == again[k], k
    resumed = os.path.join(_ckpt(root, "resume"), "sharded_state")
    assert int(np.load(os.path.join(resumed, "rank_0", "step.npy"))) == \
        STEPS + 20
    assert json.load(open(os.path.join(resumed, "layout.json")))["step"] \
        == STEPS + 20


def test_eval_dist_reads_the_sharded_checkpoint(runs):
    _, _, out = runs
    got = _metrics(out["eval"])
    want = _metrics(out["vocab"])[0]
    assert got[0] == got[1] == want


def test_another_rank_count_is_refused(runs):
    root, _, _ = runs
    from dglke_tpu_torch.cli import eval as peval
    from dglke_tpu_torch.cli import train as ptrain
    with pytest.raises(SystemExit, match=r"written by 2 rank\(s\); restore "
                                         r"it onto 2 rank\(s\) \(this run "
                                         r"has 1\)"):
        peval.main([*_eval_argv(root, _ckpt(root, "sharded")),
                    "--device", "cpu"])
    with pytest.raises(SystemExit, match=r"written by 2 rank\(s\)"):
        ptrain.main([*_data_args(root), *RECIPE, "--max_step", "2",
                     "--device", "cpu", "--init_from",
                     _ckpt(root, "sharded"), "--save_path",
                     os.path.join(root, "refused")])


def test_the_jax_sharded_format_is_refused_by_name(runs, tmp_path):
    root, _, _ = runs
    from dglke_tpu_torch.cli import eval as peval
    fake = tmp_path / "ckpt"
    (fake / "sharded_state" / "d").mkdir(parents=True)
    (fake / "sharded_state" / "manifest.ocdbt").write_bytes(b"")
    with pytest.raises(SystemExit, match="JAX package's orbax format"):
        peval.main([*_eval_argv(root, str(fake)), "--device", "cpu"])


def test_partition_path_runs(runs):
    root, _, _ = runs
    from dglke_tpu_torch.cli import partition as pcli
    assert pcli.main(["--data_path", os.path.join(root, "d"), "--dataset",
                      "planted", "--format", "udd_hrt", "--data_files",
                      *FILES, "-k", "2", "--method", "random"]) == 0
    parts = os.path.join(root, "d", "planted")
    out = wait_ranks(start_ranks(_train_argv(
        root, "parts", "--partition_path", parts, "--table_sharding",
        "vocab", "--no_save_emb", steps=20), W))
    from dglke_tpu_torch.data.partition_dataset import load_partition
    for rank, (rc, so, se) in enumerate(out):
        assert rc == 0, se[-3000:]
        n = len(load_partition(parts, rank).train[0])
        assert f"|Train|: {n}" in so
    assert "training takes" in out[0][1]


# A stand-in `ogb.lsc` serving a small wikikg90M-style dataset from the
# data directory (the `ogb` package is not installed here).
_FAKE_LSC = '''
import os
import numpy as np


class WikiKG90MDataset:
    def __init__(self, root):
        z = np.load(os.path.join(root, "wiki90m.npz"))
        self.train_hrt = z["train_hrt"]
        self.num_entities, self.num_relations = int(z["n_ent"]), int(z["n_rel"])
        self.valid_dict = {"h,r->t": {"hr": z["valid_hr"],
                                      "t_candidate": z["valid_t"],
                                      "t_correct_index": z["valid_ans"]}}
        self.test_dict = {"h,r->t": {"hr": z["test_hr"],
                                     "t_candidate": z["test_t"]}}
'''


def test_candidate_protocol_under_dist(tmp_path, monkeypatch):
    """wikikg90M's protocol under --dist, each plan: Valid metrics during
    training (logged by rank 0); at the end each rank writes
    test_{rank}.pkl, and in stride order they hold the top-10 of one
    device's eval of the npy checkpoint."""
    import pickle
    import shutil
    fake = tmp_path / "fake" / "ogb"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text("")
    (fake / "lsc.py").write_text(_FAKE_LSC)
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    n_ent, n_rel, q, k = 61, 4, 17, 9
    np.savez(data / "wiki90m.npz", n_ent=n_ent, n_rel=n_rel,
             train_hrt=np.stack([rng.integers(0, n_ent, 600),
                                 rng.integers(0, n_rel, 600),
                                 rng.integers(0, n_ent, 600)], 1),
             valid_hr=np.stack([rng.integers(0, n_ent, q),
                                rng.integers(0, n_rel, q)], 1),
             valid_t=rng.integers(0, n_ent, (q, k)),
             valid_ans=rng.integers(0, k, q),
             test_hr=np.stack([rng.integers(0, n_ent, q),
                               rng.integers(0, n_rel, q)], 1),
             test_t=rng.integers(0, n_ent, (q, k)))
    argv = ["--model_name", "TransE_l2", "--dataset", "wikikg90M",
            "--data_path", str(data), "--format", "built_in",
            "--batch_size", "32", "--neg_sample_size", "8", "--hidden_dim",
            "16", "--gamma", "5.0", "--max_step", "40", "--log_interval",
            "20", "--valid", "--eval_interval", "20", "--test",
            "--batch_size_eval", "5"]
    procs = {ts: start_ranks(cli_argv(TRAIN, [
        *argv, "--table_sharding", ts, "--save_path",
        str(tmp_path / ts)]), W, path=[str(tmp_path / "fake")])
        for ts in ("vocab", "replicated")}
    outs = {ts: wait_ranks(p) for ts, p in procs.items()}
    monkeypatch.syspath_prepend(str(tmp_path / "fake"))
    for mod in ("ogb", "ogb.lsc"):
        monkeypatch.delitem(sys.modules, mod, raising=False)
    from dglke_tpu_torch.cli import eval as peval
    for ts, out in outs.items():
        valid = []
        for rank, (rc, so, se) in enumerate(out):
            assert rc == 0, se[-3000:]
            valid.append(re.findall(rf"\[{rank}\]Valid average (\S+): (\S+)",
                                    so))
        # the train loop logs on rank 0 only: two Valid evals of 5 metrics
        assert len(valid[0]) == 10 and valid[1] == [], valid
        ckpt = os.path.join(tmp_path, ts, "TransE_l2_wikikg90M_0")
        parts = []
        for rank in range(W):
            with open(os.path.join(ckpt, f"test_{rank}.pkl"), "rb") as f:
                parts.append(pickle.load(f)["h,r->t"]["t_pred_top10"])
        one_dir = tmp_path / f"{ts}_one"
        shutil.copytree(ckpt, one_dir)
        for rank in range(W):
            os.remove(one_dir / f"test_{rank}.pkl")
        assert peval.main(["--dataset", "wikikg90M", "--data_path",
                           str(data), "--format", "built_in",
                           "--model_path", str(one_dir),
                           "--batch_size_eval", "5", "--device",
                           "cpu"]) == 0
        with open(one_dir / "test_0.pkl", "rb") as f:
            one = pickle.load(f)["h,r->t"]["t_pred_top10"]
        assert one.shape == (q, 9)
        for rank in range(W):
            np.testing.assert_array_equal(parts[rank], one[rank::W])
