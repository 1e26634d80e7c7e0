"""The count functions against numbers worked by hand at the flagship
(TransE_l2, dim 400) and RESCAL (hidden 500) shapes: batch 1,000, 200
negatives a chunk, 5 chunks, so 3,000 entity ids and 1,000 relation ids a
step."""

import pytest

from kgbench import peaks
from kgbench.spec import PACKAGE, load_cell, load_module
from kgbench.trace import TraceSummary


def flags(workload):
    return load_cell(workload).config["flags"]


def counts(workload):
    return load_cell(workload).counts()


def test_transe_l2_step_flops():
    f = flags("fb15k-transe_l2.train")
    c = counts("fb15k-transe_l2.train")
    # pos 4BD + B; neg 3BD + 2CKD + 2BKD + 5BK; loss 11BK + 4B; reg 4(Ne+Nr)D
    fwd = (1_600_000 + 1_000) + (1_200_000 + 800_000 + 160_000_000
                                 + 1_000_000) + 2_204_000 + 6_400_000
    assert c.forward_flops(f) == fwd == 173_205_000
    # backward twice the forward; Adagrad 6 a gradient element (4,000 rows)
    assert c.step_flops(f) == 3 * fwd + 6 * 4_000 * 400 == 529_215_000


def test_transe_l2_kernel_bytes():
    f = flags("fb15k-transe_l2.train")
    got = counts("fb15k-transe_l2.train").kernel_bytes(f, 2718, 703)
    # K1: distinct rows read, every row written, ids read
    assert got["k1"][0] == (2718 * 1600 + 3000 * 1600 + 3000 * 4
                            + 703 * 1600 + 1000 * 1600 + 1000 * 4)
    # K2: grouping 16 B an id; update 12 B an id, its gradient row, and
    # each distinct row and state read and written
    want = (16 * 4000 + 12 * 3000 + 3000 * 1600 + 2 * 2718 * 1604
            + 12 * 1000 + 1000 * 1600 + 2 * 703 * 1604)
    assert got["k2"][0] == want
    assert "k3" not in got


def test_rescal_step_flops_and_k3():
    f = flags("fb15k-rescal.train")
    c = counts("fb15k-rescal.train")
    fwd = (500_000_000 + 1_000_000 + 200_000_000 + 2_204_000 + 6_000_000
           + 1_000_000_000)
    assert c.forward_flops(f) == fwd
    assert c.step_flops(f) == 3 * fwd + 9_000_000 + 2_500_000_000
    got = c.kernel_bytes(f, 2718, 703)
    assert got["k3"][0] == 12_000 + 4_000_000 + 2 * 703 * 1_000_004
    assert got["k3"][1] == 7 * 250_000_000 + 3 * 703 * 250_000
    # K1 reads each distinct 1 MB relation row once and writes 1,000
    assert got["k1"][0] == pytest.approx(
        2718 * 2000 + 3000 * 2000 + 12_000 + 703e6 + 1e9 + 4_000)


def test_roofline_reader_is_bound_over_time():
    cell = load_cell("fb15k-transe_l2.train")
    reader = cell.readers["k1_roofline.train"]
    trace = TraceSummary(window_s=1.0, busy_s=0.9,
                         kernel_s={"gather_rows_vec4": 2e-3,
                                   "segment_update_warp": 1e-3})
    ctx = {"trace": trace, "kernels": {"k1": (3.35e9, 0)}}
    # 3.35 GB take 1 ms at 3.35 TB/s; K1 ran 2 ms
    assert reader.read(ctx) == pytest.approx(50.0)
    assert cell.readers["k2_roofline.train"].read(ctx) is None
    assert cell.readers["device_idle_pct.train"].read(ctx) == \
        pytest.approx(10.0)
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)


def transr_flags():
    """dgl-ke's FB15k TransR recipe (examples/fb15k.sh): hidden 200, batch
    1,000, 200 negatives a chunk."""
    f = dict(flags("fb15k-transe_l2.train"))
    f.update(model_name="TransR", hidden_dim=200, gamma=8.0)
    return f


def test_transr_step_flops():
    c = load_module(PACKAGE / "counts" / "transr.py")
    f = transr_flags()
    # h M_r, t M_r: 2 x 2BD^2; every negative by every relation of its
    # chunk: 2BKD^2 = 16 GFLOP; pos 4BD; neg BD + 3BKD + BK; loss 11BK +
    # 4B; regularization of the entity and relation rows 4(Ne+Nr)D
    fwd = (160_000_000 + 16_000_000_000 + 800_000
           + (200_000 + 120_000_000 + 200_000) + 2_204_000 + 3_200_000)
    assert c.forward_flops(f) == fwd == 16_286_604_000
    # Adagrad 6 a gradient element: 3,000 entity, 1,000 relation and
    # 1,000 projection rows
    assert c.step_flops(f) == 3 * fwd + 6 * (3000 * 200 + 1000 * 200
                                             + 1000 * 40_000)


def test_transr_kernel_bytes_count_the_projection():
    c = load_module(PACKAGE / "counts" / "transr.py")
    got = c.kernel_bytes(transr_flags(), 2718, 703)
    assert got["k1"][0] == (2718 * 800 + 3000 * 800 + 3000 * 4
                            + 703 * 800 + 1000 * 800 + 1000 * 4
                            + 703 * 160_000 + 1000 * 160_000 + 1000 * 4)
    # three groupings, and three updates
    want = (16 * 5000 + 12 * 3000 + 3000 * 800 + 2 * 2718 * 804
            + 12 * 1000 + 1000 * 800 + 2 * 703 * 804
            + 12 * 1000 + 1000 * 160_000 + 2 * 703 * 160_004)
    assert got["k2"][0] == want
    assert "k3" not in got


def test_wikikg2_step_ids_and_bytes():
    """batch 512, 128 negatives a chunk, 4 chunks: 1,536 entity ids and
    512 relation ids a step, 2 KB rows."""
    f = flags("wikikg2-transe_l2.train")
    got = counts("wikikg2-transe_l2.train").kernel_bytes(f, 1530, 400)
    assert got["k1"][0] == (1530 * 2000 + 1536 * 2000 + 1536 * 4
                            + 400 * 2000 + 512 * 2000 + 512 * 4)
