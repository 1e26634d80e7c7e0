"""The host-memory mapping of dglke_tpu_torch/ops/rows.py (map_host and the
one mixed case K1 and K2 take: a CPU table registered by map_host, with ids
and rows on the card), checked on the CPU.  Registration itself needs a
card (chip_smoke.py holds the kernels on mapped tables there); here a range
is entered in the registry by hand, so the address arithmetic, the
refusals and the CPU paths are covered."""

import numpy as np
import pytest
import torch

from dglke_tpu_torch.ops import rows

CUDA = torch.device("cuda")       # a device object; no card is touched


@pytest.fixture
def fake_mapped(monkeypatch):
    """A 10 x 6 fp32 table whose memory stands registered at a device-side
    address 1 << 40 above its host address."""
    table = torch.arange(60, dtype=torch.float32).reshape(10, 6)
    host = table.data_ptr()
    monkeypatch.setattr(rows, "_mapped", {host: (table.nbytes,
                                                 host + (1 << 40))})
    return table, host + (1 << 40)


def test_mapped_address_follows_views(fake_mapped):
    table, dev = fake_mapped
    assert rows.mapped_address(table) == dev
    assert rows.mapped_address(table[3:]) == dev + 3 * 6 * 4
    assert rows.mapped_address(table[2:5, 1:]) == dev + (2 * 6 + 1) * 4
    assert rows.mapped_address(table[9]) == dev + 9 * 6 * 4


def test_memory_outside_every_range_is_not_mapped(fake_mapped):
    table, _ = fake_mapped
    assert rows.mapped_address(table.clone()) is None
    assert rows.mapped_address(torch.zeros(0)) is None
    bigger = torch.zeros((20, 6))
    assert rows.mapped_address(bigger) is None


def test_reach_takes_mapped_memory_and_refuses_the_rest(fake_mapped):
    table, dev = fake_mapped
    assert rows._reach(table, CUDA, "k", "table") == dev
    assert rows._reach(table, torch.device("cpu"), "k", "table") == \
        table.data_ptr()
    with pytest.raises(ValueError, match="only through map_host"):
        rows._reach(table.clone(), CUDA, "k", "table")


def test_map_host_refuses_what_it_cannot_pin():
    a = np.zeros((4, 6), np.float32)
    with pytest.raises(ValueError, match="C-contiguous"):
        rows.map_host(a[:, :3])
    a.flags.writeable = False
    with pytest.raises(ValueError, match="writable"):
        rows.map_host(a)
    with pytest.raises(ValueError, match="not empty"):
        rows.map_host(np.zeros((0, 6), np.float32))


def test_sync_mapped_waits_only_when_a_table_is_mapped(fake_mapped,
                                                       monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(a))
    rows.sync_mapped()
    monkeypatch.setattr(rows, "_mapped", {})
    rows.sync_mapped()
    assert calls == [()]


@pytest.mark.parametrize("dim", [1, 400, 2047, 2048, 160_000])
def test_mapped_tables_take_the_mapped_shape(dim):
    """A mapped table: the blocks with the threads' own loads at every
    width (no TMA copy from host memory); a table on the card keeps the
    width's shape."""
    assert rows.gather_shape(dim, mapped=True) == rows.MAPPED_SHAPE \
        == "wide_loads"
    assert rows.gather_shape(dim) == (
        "wide" if dim >= rows.GATHER_WIDE_MIN else "warp")


def test_cpu_tables_with_cpu_ids_take_the_plain_versions(fake_mapped):
    """A mapped table with ids on the CPU is a CPU call: the plain
    versions, in place on the same memory."""
    table, _ = fake_mapped
    ids = torch.tensor([4, 1, 4], dtype=torch.int32)
    assert torch.equal(rows.gather_rows(table, ids), table[[4, 1, 4]])
    ss = torch.zeros(10)
    before = table.clone()
    rows.sparse_adagrad_rows(table, ss, ids, torch.ones((3, 6)), 0.5)
    assert float(ss[4]) == 2.0 and float(ss[1]) == 1.0
    assert torch.equal(table[0], before[0])
    assert not torch.equal(table[4], before[4])


def test_k2_refuses_rows_on_another_device_than_the_ids():
    table = torch.zeros((10, 6))
    with pytest.raises(ValueError, match="do not match"):
        rows.sparse_adagrad_rows(table, torch.zeros(10),
                                 torch.zeros(3, dtype=torch.int32),
                                 torch.zeros((3, 6), device="meta"), 0.5)
    with pytest.raises(ValueError, match="state_sum"):
        rows.sparse_adagrad_rows(table, torch.zeros(10, device="meta"),
                                 torch.zeros(3, dtype=torch.int32),
                                 torch.zeros((3, 6)), 0.5)
