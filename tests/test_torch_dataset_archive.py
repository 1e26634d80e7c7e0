"""A built-in dataset given as {data_path}/{name}.zip loads in
dglke_tpu_torch as in the JAX package: the archive is extracted; a corrupt
one is fetched again; with neither the directory nor a fetchable archive,
the JAX package's FileNotFoundError.  No network: urlopen is replaced."""

import io
import urllib.request
import zipfile

import numpy as np
import pytest

import jax  # noqa: F401  (on the CPU: tests/conftest.py)

from dglke_tpu.data.dataset import get_dataset as jax_get_dataset
from dglke_tpu_torch.data.dataset import DATASET_URL, get_dataset


def _zip_bytes(name="FB15k") -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr(f"{name}/entities.dict", "0\ta\n1\tb\n2\tc\n")
        zf.writestr(f"{name}/relations.dict", "0\tr\n1\ts\n")
        zf.writestr(f"{name}/train.txt", "a\tr\tb\nb\ts\tc\nc\tr\ta\n")
        zf.writestr(f"{name}/valid.txt", "a\ts\tc\n")
        zf.writestr(f"{name}/test.txt", "b\tr\ta\n")
    return buf.getvalue()


@pytest.fixture
def fetches(monkeypatch):
    """urlopen serving the good archive; the URLs asked for."""
    urls = []

    def fake_urlopen(url, timeout=None):
        urls.append(url)
        return io.BytesIO(_zip_bytes())

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    return urls


def _same(ds, jds):
    assert (ds.n_entities, ds.n_relations) == (jds.n_entities,
                                               jds.n_relations) == (3, 2)
    for split in ("train", "valid", "test"):
        for a, b in zip(getattr(ds, split), getattr(jds, split)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["FB15k", "wn18"])
def test_archive_in_data_path_is_extracted(tmp_path, fetches, name):
    for pkg in ("jax", "torch"):
        (tmp_path / pkg).mkdir()
        (tmp_path / pkg / f"{name}.zip").write_bytes(_zip_bytes(name))
    ds = get_dataset(str(tmp_path / "torch"), name, "built_in")
    _same(ds, jax_get_dataset(str(tmp_path / "jax"), name, "built_in"))
    assert fetches == []
    assert (tmp_path / "torch" / name / "train.txt").exists()


def test_corrupt_archive_is_fetched_again(tmp_path, fetches):
    (tmp_path / "FB15k.zip").write_bytes(b"not a zip")
    ds = get_dataset(str(tmp_path), "FB15k", "built_in")
    assert fetches == [DATASET_URL.format("FB15k")]
    assert ds.n_entities == 3
    assert zipfile.is_zipfile(tmp_path / "FB15k.zip")
    get_dataset(str(tmp_path), "FB15k", "built_in")      # on disk now
    assert len(fetches) == 1


def test_missing_archive_is_fetched(tmp_path, fetches):
    ds = get_dataset(str(tmp_path / "data"), "FB15k", "built_in")
    assert fetches == ["https://data.dgl.ai/dataset/FB15k.zip"]
    assert ds.n_relations == 2


def test_no_archive_and_no_network_raise_as_jax(tmp_path, monkeypatch):
    def no_net(url, timeout=None):
        raise OSError("no egress")

    monkeypatch.setattr(urllib.request, "urlopen", no_net)
    msgs = []
    for get in (get_dataset, jax_get_dataset):
        with pytest.raises(FileNotFoundError,
                           match="no network egress") as e:
            get(str(tmp_path / "data"), "FB15k", "built_in")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
