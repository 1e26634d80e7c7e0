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
def test_mapped_tables_take_the_mapped_shape(fake_mapped, dim, monkeypatch):
    """A mapped table: the line-window shape at every width (whole 128-byte
    lines into shared memory, no TMA copy from host memory); a table on the
    card keeps the width's shape.  K2 on a mapped table starts from the
    rows the caller gathered at the ids, and refuses a call without them
    (or with rows of another shape) before it launches anything; the
    grouping is stubbed out, so no card is touched."""
    assert rows.gather_shape(dim, mapped=True) == "mapped"
    assert rows.gather_shape(dim) == (
        "wide" if dim >= rows.GATHER_WIDE_MIN else "warp")
    table, _ = fake_mapped
    ss = torch.zeros(10)
    monkeypatch.setitem(rows._mapped, ss.data_ptr(), (ss.nbytes, 1 << 41))
    monkeypatch.setattr(rows, "group_ids", lambda *a: pytest.fail(
        "K2 launched on a mapped table without its rows"))
    ids = torch.zeros(3, dtype=torch.int32)
    grads = torch.zeros((3, 6))
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda t: CUDA if t is ids or t is grads else torch.device("cpu")))
    with pytest.raises(ValueError, match="needs its rows"):
        rows.sparse_adagrad_rows(table, ss, ids, grads, 0.5)
    with pytest.raises(ValueError, match="needs its rows"):
        rows.scatter_add_rows(table, ids, grads)
    with pytest.raises(ValueError, match="needs its rows"):
        rows.sparse_adagrad_rows(table, ss, ids, grads, 0.5,
                                 rows=torch.zeros((3, dim + 6)))


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


def _lines_touched(offset: int, width: int, elem: int):
    """The 128-byte lines any byte of ``width`` elements at ``offset``
    falls on, by listing every element's first and last byte."""
    starts = offset + elem * np.arange(width, dtype=np.int64)
    return np.unique(np.concatenate([starts, starts + elem - 1]) // 128)


@pytest.mark.parametrize("row_id", [6, 7])
@pytest.mark.parametrize("extra", [0, 3])
@pytest.mark.parametrize("width", [1, 100, 384, 400, 2047, 160_000])
def test_line_window_covers_a_row_and_its_chunks_fit_a_slot(width, extra,
                                                            row_id):
    """line_window gives the first line, the number of lines and the shift
    of a row of ``width`` fp32 elements at a pitch above the width, for an
    even and an odd id, in a table at a 2 MB-aligned base and at numpy's
    16-byte offset; each mapped_chunk window of the row fits the kernel's
    slot, and the windows together cover exactly the row's lines."""
    pitch = width + extra
    chunk = rows.mapped_chunk(width)
    assert 0 < chunk <= width and chunk * 4 <= (rows.MAPPED_SLOT_BYTES
                                                - rows.LINE_BYTES)
    for base in (0, 16):
        offset = base + row_id * pitch * 4
        lines = _lines_touched(offset, width, 4)
        first, count, shift = rows.line_window(offset, width)
        assert (first, count) == (lines[0], len(lines))
        assert shift == offset - first * rows.LINE_BYTES
        assert 0 <= shift < rows.LINE_BYTES and shift % 4 == 0
        covered = []
        for c0 in range(0, width, chunk):
            f, k, s = rows.line_window(offset + 4 * c0,
                                       min(chunk, width - c0))
            assert k * rows.LINE_BYTES <= rows.MAPPED_SLOT_BYTES
            assert s == (offset + 4 * c0) % rows.LINE_BYTES
            covered.extend(range(f, f + k))
        assert set(covered) == set(lines.tolist())


@pytest.mark.parametrize("elem", [2, 4])
def test_mapped_chunk_is_whole_lines_below_the_slot(elem):
    """A wide row's windows are a whole number of lines (1,920 bytes), so
    every chunk of a row shares the row's shift; a row that fits is one
    window."""
    chunk = rows.mapped_chunk(10 ** 6, elem)
    assert chunk * elem == rows.MAPPED_SLOT_BYTES - rows.LINE_BYTES
    assert chunk * elem % rows.LINE_BYTES == 0
    assert rows.mapped_chunk(400, elem) == 400


@pytest.mark.parametrize("adagrad", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mapped_route_plain_is_the_plain_update_bit_for_bit(adagrad, dtype):
    """K2's mapped route in plain PyTorch (the distinct rows gathered into
    scratch in segment order, updated there, written back) gives exactly
    the plain update's bits: the same sums in the same order."""
    rng = np.random.default_rng(3)
    n_rows, d, n = 40, 24, 150
    emb = torch.from_numpy(rng.normal(size=(n_rows, d)).astype(np.float32))
    emb = emb.to(dtype)
    ss = torch.from_numpy(rng.uniform(0.1, 2.0, n_rows).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, n_rows - 5, n).astype(np.int32))
    grads = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    want_emb, want_ss = emb.clone(), ss.clone()
    got_emb, got_ss = emb.clone(), ss.clone()
    if adagrad:
        rows.sparse_adagrad_plain(want_emb, want_ss, ids, grads, 0.3)
        rows.segment_update_mapped_plain(got_emb, got_ss, ids, grads, 0.3)
    else:
        rows.scatter_add_plain(want_emb, ids, grads)
        rows.segment_update_mapped_plain(got_emb, None, ids, grads, 0.0)
    assert torch.equal(got_emb, want_emb) and torch.equal(got_ss, want_ss)
    assert torch.equal(got_emb[-5:], emb[-5:])    # untouched rows


@pytest.mark.parametrize("shape", [(10, 6), (1000, 400), (7,), (0, 4)])
def test_host_zeros_is_aligned_zeroed_and_writable(shape):
    a = rows.host_zeros(shape)
    assert a.shape == shape and a.dtype == np.float32
    assert a.flags.c_contiguous and a.flags.writeable
    assert a.ctypes.data % rows.HUGE_PAGE_BYTES == 0
    assert not a.any()
    a[...] = 2.0
    assert float(a.sum()) == 2.0 * a.size
    assert "in 2 MB pages" in rows.host_pages([a])


def test_map_host_takes_host_zeros_arrays(monkeypatch):
    """map_host registers a host_zeros array as any other (a stand-in
    library records the range), and mapped_address then finds it."""
    seen = []

    class FakeLib:
        @staticmethod
        def dglke_host_register(host, n_bytes, dev):
            seen.append((host, n_bytes))
            dev._obj.value = host + (1 << 40)
            return 0

        @staticmethod
        def dglke_host_unregister(host):
            return 0

    monkeypatch.setattr(rows, "_mapped", {})
    monkeypatch.setattr(rows, "load_library", lambda *a: FakeLib)
    monkeypatch.setattr(torch.cuda, "init", lambda: None)
    a = rows.host_zeros((12, 8))
    t = rows.map_host(a)
    assert seen == [(a.ctypes.data, a.nbytes)]
    assert t.data_ptr() == a.ctypes.data and torch.equal(t, torch.zeros(12, 8))
    assert rows.mapped_address(t[3:]) == a.ctypes.data + (1 << 40) + 3 * 32
