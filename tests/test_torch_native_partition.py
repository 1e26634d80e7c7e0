"""The port's native LDG partitioner (dglke_tpu_torch/data/native.py, its
own copy of the C++ core) against the JAX package's
dglke_tpu.data.native.ldg_partition_native: the same assignment and cut,
bit for bit, for k in 1-4 and three seeds on graphs with isolated nodes,
self-loops and duplicate edges; partition_and_write and the partition CLI
on their default (LDG) paths write byte-identical artifacts to the JAX
package's default path, unpatched; bad ids raise ValueError; and a failed
build raises instead of falling back to the numpy LDG, whose other stream
order would write other partitions.

The JAX package's native module is given a private build for the length
of this module (jax_native): its own _load runs ``make`` in the shared
native/ directory with no lock, so under pytest-xdist another worker's
build can rewrite the library while this one loads it, and the reference
then reports itself unavailable for the rest of the worker's life."""

import filecmp
import os
import shutil

import numpy as np
import pytest

from dglke_tpu.data import native as jnative
from dglke_tpu.data import partition_graph as jpg
from dglke_tpu_torch.data import native as pnative
from dglke_tpu_torch.data import partition_graph as ppg
from dglke_tpu_torch.data.dataset import synthetic_dataset

N_NODES = 120


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native module built from its own sources (the
    Makefile and both C++ files copied) into a directory of this module's
    alone, and loaded by its own _load; restored after the module."""
    src = jnative._NATIVE_DIR
    build = tmp_path_factory.mktemp("jax_native")
    for name in ("Makefile", "kge_sampler.cpp", "ldg_partition.cpp"):
        shutil.copy(os.path.join(src, name), build / name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_NATIVE_DIR", str(build))
        mp.setattr(jnative, "_SO_PATH", str(build / "libkge_native.so"))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_build_failed", False)
        assert jnative._load() is not None, "the JAX native build failed"
        yield jnative


def _graph(seed: int):
    """Edges over N_NODES nodes, nodes 100-119 isolated, with self-loops
    and repeated edges."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 100, 700)
    t = np.where(rng.random(700) < 0.8, (h + rng.integers(1, 6, 700)) % 100,
                 rng.integers(0, 100, 700))
    loops = rng.integers(0, 100, 25)
    dup = rng.integers(0, 700, 60)
    h = np.concatenate([h, loops, h[dup]])
    t = np.concatenate([t, loops, t[dup]])
    return h.astype(np.int64), t.astype(np.int64)


@pytest.mark.usefixtures("jax_native")
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_native_ldg_matches_jax_native(k, seed):
    h, t = _graph(seed)
    got, got_cut = pnative.ldg_partition_native(h, t, N_NODES, k, seed)
    want, want_cut = jnative.ldg_partition_native(h, t, N_NODES, k, seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got_cut == want_cut == int(np.sum(got[h] != got[t]))
    assert got.min() >= 0 and got.max() < k
    if k > 1:
        # the two forms draw other stream orders (repair C5): the numpy one
        # is not what the partitioner writes
        assert not np.array_equal(ppg.ldg_partition(h, t, N_NODES, k, seed),
                                  got)


def _tree_equal(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only, (cmp.left_only,
                                                      cmp.right_only)
    for sub in cmp.common_dirs:
        _tree_equal(os.path.join(a, sub), os.path.join(b, sub))
    for f in cmp.common_files:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


@pytest.mark.usefixtures("jax_native")
@pytest.mark.parametrize("k", [2, 3])
def test_partition_and_write_default_path_is_byte_identical(tmp_path, k):
    ds = synthetic_dataset(n_entities=97, n_relations=7, n_train=1500,
                           n_valid=20, n_test=30, seed=5)
    pout = ppg.partition_and_write(ds.train, 97, 7, k,
                                   str(tmp_path / "p" / "partition_"))
    jout = jpg.partition_and_write(ds.train, 97, 7, k,
                                   str(tmp_path / "j" / "partition_"))
    np.testing.assert_array_equal(pout["assign"], jout["assign"])
    assert pout["edge_cut"] == jout["edge_cut"]
    h, _, t = ds.train
    native_assign, _ = jnative.ldg_partition_native(h, t, 97, k, 0)
    np.testing.assert_array_equal(pout["assign"], native_assign)
    _tree_equal(str(tmp_path / "p"), str(tmp_path / "j"))


@pytest.mark.usefixtures("jax_native")
def test_partition_cli_default_method_writes_the_jax_clis_files(tmp_path):
    from dglke_tpu.cli import partition as jcli
    from dglke_tpu_torch.cli import partition as pcli
    ds = synthetic_dataset(n_entities=61, n_relations=4, n_train=800,
                           n_valid=10, n_test=10, seed=2)
    for side, main in (("p", pcli.main), ("j", jcli.main)):
        d = tmp_path / side
        d.mkdir()
        (d / "entities.tsv").write_text(
            "".join(f"{i}\te{i}\n" for i in range(61)))
        (d / "relations.tsv").write_text(
            "".join(f"{i}\tr{i}\n" for i in range(4)))
        for split in ("train", "valid", "test"):
            np.savetxt(d / f"{split}.txt", np.stack(getattr(ds, split),
                                                    axis=1),
                       fmt="%d", delimiter="\t")
        assert main(["--data_path", str(d), "--dataset", "kg", "--format",
                     "udd_hrt", "--data_files", "entities.tsv",
                     "relations.tsv", "train.txt", "valid.txt", "test.txt",
                     "-k", "3"]) == 0
    _tree_equal(str(tmp_path / "p" / "kg"), str(tmp_path / "j" / "kg"))


@pytest.mark.usefixtures("jax_native")
@pytest.mark.parametrize("h,t,n,k", [
    ([0, 1, 5], [1, 2, 0], 5, 2),     # id == n_nodes
    ([0, -1], [1, 2], 5, 2),          # negative id
    ([0, 1], [1, 2], 5, 0),           # k == 0
    ([0, 1], [1, 2], 5, -3),          # k < 0
], ids=["id_past_end", "negative_id", "k_zero", "k_negative"])
def test_bad_inputs_raise(h, t, n, k):
    h, t = np.asarray(h), np.asarray(t)
    with pytest.raises(ValueError, match="invalid inputs"):
        pnative.ldg_partition_native(h, t, n, k)
    with pytest.raises(ValueError):
        jnative.ldg_partition_native(h, t, n, k)


def test_mismatched_edge_arrays_raise():
    with pytest.raises(ValueError, match="one length"):
        pnative.ldg_partition_native(np.arange(3), np.arange(4), 5, 2)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """No library loaded and none built: the next call must build."""
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_no_compiler_raises_and_writes_nothing(fresh_build, monkeypatch):
    monkeypatch.setattr(pnative.shutil, "which", lambda name: None)
    ds = synthetic_dataset(n_entities=30, n_relations=2, n_train=200,
                           n_valid=5, n_test=5)
    out = fresh_build / "parts" / "partition_"
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        ppg.partition_and_write(ds.train, 30, 2, 2, str(out))
    assert not (fresh_build / "parts").exists()
    # the random partitioner needs no native code
    ppg.partition_and_write(ds.train, 30, 2, 2, str(out), method="random")
    assert (fresh_build / "parts" / "partition_1" / "train.txt").exists()


def test_failed_compile_raises_with_the_compilers_output(fresh_build,
                                                         monkeypatch):
    monkeypatch.setattr(pnative, "CXX_FLAGS",
                        pnative.CXX_FLAGS + ("--no-such-flag",))
    with pytest.raises(RuntimeError, match="no-such-flag"):
        pnative.ldg_partition_native(np.arange(3), np.arange(3), 5, 2)
    assert not list((fresh_build / "build").glob("*.so"))


@pytest.mark.usefixtures("jax_native")
def test_build_is_keyed_by_the_source_digest(fresh_build):
    h, t = _graph(3)
    a, _ = pnative.ldg_partition_native(h, t, N_NODES, 2, 3)
    (so,) = (fresh_build / "build").glob("ldg_partition_*.so")
    assert so == pnative.library_path(pnative._compiler())
    np.testing.assert_array_equal(
        a, jnative.ldg_partition_native(h, t, N_NODES, 2, 3)[0])
