"""The port's edge partitioners and partition artifacts against the JAX
package's: random_partition, balanced / soft relation partitioning and
partition_for_host give the same parts; the numpy LDG gives the same
assignment; partition_and_write writes byte-identical artifacts (random,
and LDG with both sides held to their numpy LDG; the native default paths
are compared in test_torch_native_partition.py), which load_partition
reads back; an edgeless partition is refused as the JAX package refuses it; the
partition CLI writes the same files as the JAX one."""

import filecmp
import os
import warnings

import numpy as np
import pytest

from dglke_tpu.data import partition_graph as jpg
from dglke_tpu.data import sampler as jsampler
from dglke_tpu.data.dataset import synthetic_dataset as jax_synthetic
from dglke_tpu.data.partition_dataset import load_partition as jax_load
from dglke_tpu_torch.data import partition_graph as ppg
from dglke_tpu_torch.data import sampler as psampler
from dglke_tpu_torch.data.dataset import synthetic_dataset
from dglke_tpu_torch.data.partition_dataset import load_partition

N_ENT, N_REL, N_TRAIN = 97, 7, 1500


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(n_entities=N_ENT, n_relations=N_REL,
                             n_train=N_TRAIN, n_valid=20, n_test=30, seed=5)


def _same_parts(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_random_partition_matches_jax(ds, k):
    _same_parts(psampler.random_partition(ds.train, k),
                jsampler.random_partition(ds.train, k))


@pytest.mark.parametrize("k", [2, 3])
def test_relation_partitions_match_jax(ds, k):
    p, j = (m.balanced_relation_partition(ds.train, k)
            for m in (psampler, jsampler))
    _same_parts(p[0], j[0])
    _same_parts(p[1], j[1])
    assert p[2] == j[2]
    for threshold in (0.05, 0.3):
        p, j = (m.soft_relation_partition(ds.train, k, threshold)
                for m in (psampler, jsampler))
        _same_parts(p[0], j[0])
        _same_parts(p[1], j[1])
        assert p[2:] == j[2:]


@pytest.mark.parametrize("rel_part", [False, True])
@pytest.mark.parametrize("rank", [0, 1])
def test_partition_for_host_matches_jax(ds, rank, rel_part):
    jds = jax_synthetic(n_entities=N_ENT, n_relations=N_REL,
                        n_train=N_TRAIN, n_valid=20, n_test=30, seed=5)
    got = psampler.partition_for_host(ds, rank, 2, rel_part=rel_part)
    want = jsampler.partition_for_host(jds, rank, 2, rel_part=rel_part)
    for g, w in zip(got.train, want.train):
        np.testing.assert_array_equal(g, w)
    assert got.train_partitioned and want.train_partitioned
    np.testing.assert_array_equal(got.test[0], ds.test[0])
    assert psampler.partition_for_host(ds, 0, 1) is ds


def test_partition_for_host_refuses_an_empty_part():
    tiny = synthetic_dataset(n_entities=10, n_relations=2, n_train=2,
                             n_valid=1, n_test=1)
    with pytest.raises(ValueError, match="empty edge partition"):
        psampler.partition_for_host(tiny, 2, 3)


@pytest.mark.parametrize("k", [2, 3])
def test_ldg_assignment_matches_jax_numpy_ldg(ds, k):
    h, _, t = ds.train
    np.testing.assert_array_equal(ppg.ldg_partition(h, t, N_ENT, k, seed=3),
                                  jpg.ldg_partition(h, t, N_ENT, k, seed=3))


def _tree_equal(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files, (
        cmp.left_only, cmp.right_only, cmp.diff_files)
    for sub in cmp.common_dirs:
        _tree_equal(os.path.join(a, sub), os.path.join(b, sub))
    for f in cmp.common_files:   # filecmp's shallow compare, made exact
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


@pytest.mark.parametrize("method", ["random", "ldg"])
def test_partition_and_write_is_byte_identical(ds, tmp_path, monkeypatch,
                                               method):
    # the numpy LDG on both sides: the JAX side falls back to it when its
    # native call fails; the port's native call is replaced by it (the
    # native default paths: test_torch_native_partition.py)
    from dglke_tpu.data import native
    monkeypatch.setattr(native, "ldg_partition_native",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("numpy LDG")), raising=False)
    monkeypatch.setattr(ppg, "ldg_partition_native",
                        lambda h, t, n, k, seed: (
                            ppg.ldg_partition(h, t, n, k, seed), None))
    pout = ppg.partition_and_write(ds.train, N_ENT, N_REL, 3,
                                   str(tmp_path / "p" / "partition_"),
                                   method=method)
    jout = jpg.partition_and_write(ds.train, N_ENT, N_REL, 3,
                                   str(tmp_path / "j" / "partition_"),
                                   method=method)
    assert pout["edge_cut"] == jout["edge_cut"]
    np.testing.assert_array_equal(pout["assign"], jout["assign"])
    _tree_equal(str(tmp_path / "p"), str(tmp_path / "j"))
    for rank in range(3):
        got = load_partition(str(tmp_path / "p"), rank)
        want = jax_load(str(tmp_path / "j"), rank)
        assert (got.n_entities, got.n_relations, got.n_local) == (
            want.n_entities, want.n_relations, want.n_local) == (
            N_ENT, N_REL, len(want.local_to_global))
        for g, w in zip(got.train, want.train):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got.partition_book,
                                      want.partition_book)
    # every edge lands in exactly one partition, in global ids
    edges = sorted(zip(*(np.concatenate([load_partition(
        str(tmp_path / "p"), r).train[i] for r in range(3)])
        for i in range(3))))
    assert edges == sorted(zip(*(np.asarray(x) for x in ds.train)))


def test_empty_partition_clear_error(tmp_path):
    pdir = tmp_path / "partition_0"
    pdir.mkdir()
    (pdir / "train.txt").write_text("")
    np.savetxt(pdir / "local_to_global.txt", np.arange(3), fmt="%d")
    (pdir / "relation_count.txt").write_text("2\n")
    np.savetxt(pdir / "partition_book.txt", np.zeros(3), fmt="%d")
    with pytest.raises(ValueError, match="no edges"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # loadtxt empty file
        load_partition(str(tmp_path), 0)


def test_partition_cli_writes_the_jax_clis_files(tmp_path, ds):
    from dglke_tpu.cli import partition as jcli
    from dglke_tpu_torch.cli import partition as pcli
    for side in ("p", "j"):
        d = tmp_path / side          # the udd files; partitions under kg/
        d.mkdir()
        (d / "entities.tsv").write_text(
            "".join(f"{i}\te{i}\n" for i in range(N_ENT)))
        (d / "relations.tsv").write_text(
            "".join(f"{i}\tr{i}\n" for i in range(N_REL)))
        for split in ("train", "valid", "test"):
            np.savetxt(d / f"{split}.txt",
                       np.stack(getattr(ds, split), axis=1), fmt="%d",
                       delimiter="\t")
    for side, main in (("p", pcli.main), ("j", jcli.main)):
        assert main(["--data_path", str(tmp_path / side), "--dataset", "kg",
                     "--format", "udd_hrt", "--data_files", "entities.tsv",
                     "relations.tsv", "train.txt", "valid.txt", "test.txt",
                     "-k", "2", "--method", "random"]) == 0
    _tree_equal(str(tmp_path / "p" / "kg"), str(tmp_path / "j" / "kg"))
    assert load_partition(str(tmp_path / "p" / "kg"), 1).n_entities == N_ENT
