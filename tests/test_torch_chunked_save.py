"""The chunked table save of dglke_tpu_torch/utils/io.py (a copy of the JAX
package's _save_table / _atomic_save_rows): tables above the threshold
stream in row chunks into the npy file, sliced to their logical width and
upcast to fp32 on the host.  The thresholds are made tiny here so that
small tables stream in many chunks; the artifacts must hold exactly the
bytes of the whole table's fp32 rows, and the JAX package must read them.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (on the CPU: tests/conftest.py)

from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.models.ke_model import KEModel as JaxModel
from dglke_tpu.utils import io as jax_io
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.utils import io as pt_io

torch.set_num_threads(2)


@pytest.fixture
def tiny_chunks(monkeypatch):
    """Stream every table, 3 rows of 16 fp32 a chunk (192 bytes), 2 in
    flight."""
    monkeypatch.setattr(pt_io, "_STREAM_THRESHOLD", 1)
    monkeypatch.setattr(pt_io, "_STREAM_CHUNK", 192)
    monkeypatch.setattr(pt_io, "_STREAM_WORKERS", 2)


@pytest.mark.parametrize("n_rows,dim", [(37, 16), (36, 16), (1, 16),
                                        (20, 11)],
                         ids=["ragged", "whole_chunks", "one_row", "sliced"])
def test_streamed_table_holds_the_whole_tables_bytes(tiny_chunks, tmp_path,
                                                     n_rows, dim):
    """Rows and columns past (n_rows, dim) are not written; what is
    written is the fp32 table's bytes, as np.save of the whole table."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(40, 16)).astype(np.float32)
    path = str(tmp_path / "t.npy")
    pt_io._save_table(path, torch.from_numpy(table), n_rows, dim)
    whole = str(tmp_path / "whole.npy")
    np.save(whole, np.ascontiguousarray(table[:n_rows, :dim]))
    got, want = np.load(path), np.load(whole)
    assert got.dtype == np.float32 and got.shape == (n_rows, dim)
    assert got.tobytes() == want.tobytes()
    assert not (tmp_path / "t.npy.tmp").exists()


@pytest.mark.parametrize("stream", [True, False], ids=["streamed", "whole"])
def test_bf16_table_is_saved_as_its_fp32_upcast(monkeypatch, tmp_path,
                                                stream):
    if stream:
        monkeypatch.setattr(pt_io, "_STREAM_THRESHOLD", 1)
        monkeypatch.setattr(pt_io, "_STREAM_CHUNK", 256)
    cfg = KGEConfig(model_name="TransE_l2", hidden_dim=8, dataset="kg",
                    emb_dtype="bfloat16", save_path=str(tmp_path))
    model = KEModel(cfg, 30, 3, device="cpu")
    state = model.init_state()
    pt_io.save_model(cfg, model, state)
    for name in ("entity", "relation"):
        table = getattr(state, name).emb
        assert table.dtype == torch.bfloat16
        got = np.load(str(tmp_path / f"kg_TransE_l2_{name}.npy"))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, table.float().numpy())


def test_streamed_transr_checkpoint_reads_in_jax(tiny_chunks, tmp_path):
    """TransR's projection table streams sliced to the model's proj_dim
    under dgl-ke's spelling; the JAX package's load_model_state reads
    every table of the checkpoint bit for bit."""
    cfg = KGEConfig(model_name="TransR", hidden_dim=4, dataset="kg",
                    save_path=str(tmp_path))
    model = KEModel(cfg, 25, 3, device="cpu")
    state = model.init_state()
    state.step = 5
    pt_io.save_model(cfg, model, state)
    assert (tmp_path / "kg_TransRprojection.npy").exists()
    jcfg = JaxConfig.load(str(tmp_path / "config.json"))
    jm = JaxModel(jcfg, 25, 3)
    jstate = jax_io.load_model_state(jcfg, jm, str(tmp_path))
    assert int(jstate.step) == 5
    for name in ("entity", "relation", "projection"):
        want = getattr(state, name).emb.numpy()
        got = np.asarray(getattr(jstate, name).emb)
        assert got.shape[0] >= want.shape[0]
        np.testing.assert_array_equal(
            got[:want.shape[0], :want.shape[1]], want)
    np.testing.assert_array_equal(
        np.load(str(tmp_path / "kg_TransRprojection.npy")),
        state.projection.emb[:, :model.proj_dim].numpy())


def test_small_tables_are_saved_whole(monkeypatch, tmp_path):
    """Below the threshold a table is written in one np.save (no streamed
    header): the file is np.save's, byte for byte."""
    calls = []
    monkeypatch.setattr(pt_io, "_atomic_save_rows",
                        lambda *a, **k: calls.append(a))
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    path = str(tmp_path / "t.npy")
    pt_io._save_table(path, table, 4, 3)
    whole = str(tmp_path / "whole.npy")
    np.save(whole, table.numpy())
    assert calls == []
    assert open(path, "rb").read() == open(whole, "rb").read()
