"""dglke_tpu_torch-predict / -emb_sim / -convert against the JAX package's
CLIs on the same checkpoint and files (the port with --device cpu): the
TSVs are equal row for row, ids and names exactly and scores within rtol
1e-5 / atol 1e-5, in every input format and exec mode, with raw-id
translation; convert writes the same files.  Checkpoints cross between
the packages both ways: one written by dglke_tpu-train is served by the
port's predict, one written by dglke_tpu_torch-train by the JAX
package's.  Without a card the CLIs raise unless --device cpu is given;
--gpu selects nothing.
"""

import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (on the CPU: tests/conftest.py)

from dglke_tpu.cli import convert as jconvert
from dglke_tpu.cli import emb_sim as jemb_sim
from dglke_tpu.cli import predict as jpredict
from dglke_tpu_torch.cli import convert as pconvert
from dglke_tpu_torch.cli import emb_sim as pemb_sim
from dglke_tpu_torch.cli import predict as ppredict
from torch_infer_parity import (
    ATOL,
    RTOL,
    TIE_RTOL,
    random_tables,
    write_ckpt,
)

torch.set_num_threads(2)

N_ENT, N_REL, DIM = 24, 4, 8
LISTS = {"head": [1, 2, 7], "rel": [0, 3], "tail": [4, 5, 6, 11]}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A TransE_l2 checkpoint from numpy tables, its raw-id maps and the
    id lists of every slot."""
    d = tmp_path_factory.mktemp("serve")
    write_ckpt(str(d / "ck"), "TransE_l2",
               *random_tables("TransE_l2", N_ENT, N_REL, DIM, seed=0)[:2],
               gamma=6.0, dim=DIM)
    (d / "entities.tsv").write_text(
        "".join(f"{i}\tent_{i}\n" for i in range(N_ENT)))
    (d / "relations.tsv").write_text(
        "".join(f"{i}\trel_{i}\n" for i in range(N_REL)))
    for name, ids in LISTS.items():
        (d / f"{name}.list").write_text("".join(f"{i}\n" for i in ids))
        (d / f"{name}.raw").write_text(
            "".join(f"{'rel' if name == 'rel' else 'ent'}_{i}\n"
                    for i in ids))
    (d / "left.list").write_text("0\n3\n9\n")
    (d / "right.list").write_text("5\n1\n17\n")
    return d


def _read_tsv(path):
    lines = open(path).read().rstrip("\n").split("\n")
    return lines[0], [ln.split("\t") for ln in lines[1:]]


def assert_same_tsv(got_path, want_path):
    """Equal row for row: the same header and ids (or names), scores within
    tolerance.  A row's ids may differ only at a near tie: another JAX row
    scores within TIE_RTOL |s| of it (a cosine of 1 for every self-pair of
    an all-pairs similarity, say)."""
    g_head, g_rows = _read_tsv(got_path)
    w_head, w_rows = _read_tsv(want_path)
    assert g_head == w_head
    assert len(g_rows) == len(w_rows) > 0
    w_s = np.array([float(w[-1]) for w in w_rows])
    np.testing.assert_allclose([float(g[-1]) for g in g_rows], w_s,
                               rtol=RTOL, atol=ATOL)
    for i, (g, w) in enumerate(zip(g_rows, w_rows)):
        if g[:-1] != w[:-1]:
            near = np.abs(w_s - w_s[i]) <= TIE_RTOL * abs(w_s[i])
            assert near.sum() >= 2, (g, w)


def _both(jmain, pmain, argv, tmp_path):
    """Run the JAX CLI and the port's on ``argv`` (+ --output); returns the
    two output paths."""
    out = {}
    for pkg, main, extra in (("jax", jmain, []),
                             ("torch", pmain, ["--device", "cpu"])):
        out[pkg] = str(tmp_path / f"{pkg}.tsv")
        assert main([*argv, "--output", out[pkg], *extra]) == 0
    return out["torch"], out["jax"]


def _predict_files(d, fmt, raw=False):
    slots = dict(h="head", r="rel", t="tail")
    ext = "raw" if raw else "list"
    return [str(d / f"{slots[s]}.{ext}") for s in fmt.split("_") if s != "*"]


@pytest.mark.parametrize("mode", ["all", "batch_head", "batch_rel",
                                  "batch_tail"])
@pytest.mark.parametrize("fmt", ppredict.FORMATS)
def test_predict_tsv_matches_jax(ckpt, tmp_path, fmt, mode):
    argv = ["--model_path", str(ckpt / "ck"), "--format", fmt,
            "--exec_mode", mode, "--topK", "5"]
    files = _predict_files(ckpt, fmt)
    if files:
        argv += ["--data_files", *files]
    assert_same_tsv(*_both(jpredict.main, ppredict.main, argv, tmp_path))


@pytest.mark.parametrize("sfunc", ["none", "logsigmoid"])
def test_predict_triplet_wise_tsv_matches_jax(ckpt, tmp_path, sfunc):
    d = ckpt
    (d / "t3.list").write_text("4\n5\n6\n")
    (d / "h3.list").write_text("1\n2\n7\n")
    (d / "r3.list").write_text("0\n3\n3\n")
    argv = ["--model_path", str(d / "ck"), "--format", "h_r_t",
            "--data_files", str(d / "h3.list"), str(d / "r3.list"),
            str(d / "t3.list"), "--exec_mode", "triplet_wise", "--topK", "2",
            "--score_func", sfunc]
    assert_same_tsv(*_both(jpredict.main, ppredict.main, argv, tmp_path))


@pytest.mark.parametrize("fmt", ["h_r_*", "*_r_t", "h_*_*"])
def test_predict_raw_names_match_jax(ckpt, tmp_path, fmt):
    argv = ["--model_path", str(ckpt / "ck"), "--format", fmt,
            "--data_files", *_predict_files(ckpt, fmt, raw=True),
            "--raw_data", "--entity_mfile", str(ckpt / "entities.tsv"),
            "--rel_mfile", str(ckpt / "relations.tsv"), "--topK", "4"]
    got, want = _both(jpredict.main, ppredict.main, argv, tmp_path)
    assert_same_tsv(got, want)
    assert _read_tsv(got)[1][0][0].startswith(("ent_", "rel_"))


def test_predict_format_needs_its_files(ckpt):
    with pytest.raises(ValueError, match="needs 2 data file"):
        ppredict.main(["--model_path", str(ckpt / "ck"), "--format",
                       "h_r_*", "--data_files", str(ckpt / "head.list"),
                       "--device", "cpu"])


EMB_CASES = [("l_r", m) for m in ("pairwise", "all", "batch_left")] + \
    [(f, m) for f in ("l_*", "*_r") for m in ("all", "batch_left")] + \
    [("*", m) for m in ("pairwise", "all", "batch_left")]


@pytest.mark.parametrize("fmt,mode", EMB_CASES)
def test_emb_sim_tsv_matches_jax(ckpt, tmp_path, fmt, mode):
    files = {"l_r": ["left.list", "right.list"], "l_*": ["left.list"],
             "*_r": ["right.list"], "*": []}[fmt]
    argv = ["--emb_file", str(ckpt / "ck" / "toy_TransE_l2_entity.npy"),
            "--format", fmt, "--exec_mode", mode, "--topK", "4"]
    if files:
        argv += ["--data_files", *(str(ckpt / f) for f in files)]
    assert_same_tsv(*_both(jemb_sim.main, pemb_sim.main, argv, tmp_path))


@pytest.mark.parametrize("sfunc", ["cosine", "l2", "l1", "dot",
                                   "ext_jaccard"])
def test_emb_sim_functions_match_jax(ckpt, tmp_path, sfunc):
    argv = ["--emb_file", str(ckpt / "ck" / "toy_TransE_l2_relation.npy"),
            "--format", "*", "--sim_func", sfunc, "--topK", "5"]
    assert_same_tsv(*_both(jemb_sim.main, pemb_sim.main, argv, tmp_path))


@pytest.mark.parametrize("fmt", ["l_r", "*"])
def test_emb_sim_raw_names_match_jax(ckpt, tmp_path, fmt):
    d = ckpt
    (d / "left.raw").write_text("ent_0\nent_3\n")
    (d / "right.raw").write_text("ent_5\nent_1\n")
    argv = ["--emb_file", str(d / "ck" / "toy_TransE_l2_entity.npy"),
            "--format", fmt, "--raw_data", "--mfile",
            str(d / "entities.tsv"), "--topK", "3"]
    if fmt == "l_r":
        argv += ["--data_files", str(d / "left.raw"), str(d / "right.raw")]
    got, want = _both(jemb_sim.main, pemb_sim.main, argv, tmp_path)
    assert_same_tsv(got, want)
    assert _read_tsv(got)[1][0][0].startswith("ent_")


@pytest.mark.parametrize("in_fmt,out_fmt,n_files", [
    ("hrt", "hrt", 3), ("raw_udd_{htr}", "udd_{htr}", 3), ("rth", "htr", 1)])
def test_convert_writes_what_jax_writes(tmp_path, in_fmt, out_fmt, n_files):
    order = in_fmt.rstrip("}").rsplit("{", 1)[-1].rsplit("_", 1)[-1]
    rng = np.random.RandomState(0)
    files = ["train.txt", "valid.txt", "test.txt"][:n_files]
    outs = {}
    for pkg, main in (("jax", jconvert.main), ("torch", pconvert.main)):
        d = tmp_path / pkg
        d.mkdir()
        for name in files:
            rows = []
            for _ in range(20):
                cols = dict(h=f"a{rng.randint(9)}", r=f"p{rng.randint(3)}",
                            t=f"a{rng.randint(9)}")
                rows.append("\t".join(cols[c] for c in order))
            (d / name).write_text("\n".join(rows) + "\n")
        rng = np.random.RandomState(0)        # the same rows for both
        out_dir = d / "out"
        assert main(["--data_path", str(d), "--data_files", *files,
                     "--format", in_fmt, "--out_format", out_fmt,
                     "--output_path", str(out_dir)]) == 0
        outs[pkg] = {f: (out_dir / f).read_text()
                     for f in sorted(os.listdir(out_dir))}
    assert outs["torch"] == outs["jax"]
    assert len(outs["torch"]) == n_files + 2


def test_convert_refuses_an_unknown_order(tmp_path):
    with pytest.raises(ValueError, match="bad format"):
        pconvert.main(["--data_path", str(tmp_path), "--data_files", "x",
                       "--format", "hxt"])


# ---------------------------------------------------------------------------
# Checkpoints across the packages


@pytest.fixture(scope="module")
def raw_kg(tmp_path_factory):
    d = tmp_path_factory.mktemp("kg")
    rng = np.random.RandomState(0)
    rows = [f"e{h}\tr{r}\te{(h + r + 1) % 30}"
            for h, r in zip(rng.randint(30, size=300),
                            rng.randint(3, size=300))]
    for name, part in (("train", rows[:240]), ("valid", rows[240:270]),
                       ("test", rows[270:])):
        (d / f"{name}.txt").write_text("\n".join(part) + "\n")
    return d


TRAIN_ARGS = ["--model_name", "TransE_l2", "--dataset", "kg", "--format",
              "raw_udd_hrt", "--data_files", "train.txt", "valid.txt",
              "test.txt", "--batch_size", "32", "--neg_sample_size", "8",
              "--hidden_dim", "8", "--gamma", "5.0", "--lr", "0.2",
              "--max_step", "16", "--log_interval", "16"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_served_across_packages(raw_kg, tmp_path, writer):
    """A checkpoint dglke_tpu-train wrote served by the port's predict and
    emb_sim, and one dglke_tpu_torch-train wrote by the JAX package's,
    with equal TSVs."""
    if writer == "jax":
        from dglke_tpu.cli.train import main as train_main
        extra = []
    else:
        from dglke_tpu_torch.cli.train import main as train_main
        extra = ["--device", "cpu"]
    save = tmp_path / "ckpts"
    assert train_main([*TRAIN_ARGS, "--data_path", str(raw_kg),
                       "--save_path", str(save), *extra]) == 0
    ck = save / "TransE_l2_kg_0"
    (tmp_path / "h.list").write_text("0\n5\n")
    argv = ["--model_path", str(ck), "--format", "h_*_*", "--data_files",
            str(tmp_path / "h.list"), "--exec_mode", "batch_head",
            "--topK", "6"]
    assert_same_tsv(*_both(jpredict.main, ppredict.main, argv, tmp_path))
    argv = ["--emb_file", str(ck / "kg_TransE_l2_entity.npy"), "--format",
            "l_*", "--data_files", str(tmp_path / "h.list"), "--topK", "3"]
    assert_same_tsv(*_both(jemb_sim.main, pemb_sim.main, argv, tmp_path))


# ---------------------------------------------------------------------------
# The device


@pytest.mark.parametrize("gpu", [[], ["--gpu", "-1"], ["--gpu", "0"]],
                         ids=["default", "gpu-1", "gpu0"])
@pytest.mark.parametrize("cli", ["predict", "emb_sim"])
def test_clis_default_to_the_card(monkeypatch, ckpt, tmp_path, cli, gpu):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if cli == "predict":
        main = ppredict.main
        argv = ["--model_path", str(ckpt / "ck"), "--format", "*_r_t",
                "--data_files", str(ckpt / "rel.list"),
                str(ckpt / "tail.list")]
    else:
        main = pemb_sim.main
        argv = ["--emb_file", str(ckpt / "ck" / "toy_TransE_l2_entity.npy"),
                "--format", "*"]
    argv += ["--output", str(tmp_path / "out.tsv"), *gpu]
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(argv)
    assert main(argv + ["--device", "cpu"]) == 0


def test_gpu_flag_prints_a_note(ckpt, tmp_path, capsys):
    assert pemb_sim.main(["--emb_file",
                          str(ckpt / "ck" / "toy_TransE_l2_entity.npy"),
                          "--format", "*", "--gpu", "-1", "--device", "cpu",
                          "--output", str(tmp_path / "o.tsv")]) == 0
    notes = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("NOTE")]
    assert len(notes) == 1 and "--gpu is a compatibility no-op" in notes[0]
