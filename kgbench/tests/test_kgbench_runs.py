"""Whole runs on the CPU at a tiny size (the plain PyTorch paths of the
port): the reference agrees with the port, and a fault planted under the
timed path turns ``correct`` false.  The look for a card is skipped by
calling ``run_cell`` directly."""

import time

import pytest
import torch

from kgbench import faults, run
from kgbench.loops.train import Run
from kgbench.reference import streams, train_steps
from kgbench.seeds import run_seed
from kgbench.spec import PACKAGE, load_module
from kgbench.trace import Spans
from kgbench.tests.tiny import tiny_cell, tiny_transr_cell

SEED = 3 ** 40   # larger than 32 bits hold
TRAIN = ["fb15k-transe_l2.train", "fb15k-rescal.train"]


def cell_of(workload):
    """The tiny cell of a BENCHMARK.json workload, or the tiny TransR
    cell for "transr"."""
    return (tiny_transr_cell() if workload == "transr" else
            tiny_cell(workload))


def run_tiny(workload, seed=SEED, trace=False):
    return run.run_cell(cell_of(workload), seed, 0.3, trace, "cpu",
                        time.perf_counter())


@pytest.mark.parametrize("workload", TRAIN + ["transr"])
def test_sound_run_is_correct(workload):
    out = run_tiny(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {
        m["name"] for m in cell_of(workload).end_to_end}


@pytest.mark.parametrize("workload", TRAIN + ["transr"])
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_training_fault_is_caught(workload, fault):
    with faults.FAULTS[fault]():
        out = run_tiny(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_stale_negatives_pass_the_first_call(workload):
    """The fault only replays have: the first group call's numbers stay
    within their limits, the third call's do not."""
    with faults.FAULTS["stale_negatives"]():
        checks = run_tiny(workload)["checks"]
    first = ("loss_gap", "grad_gap", "change_gap")
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in first)
    assert any(checks[k]["value"] > checks[k]["limit"]
               for k in checks if k.startswith("replay_"))


def test_same_seed_same_work():
    a, b = (tiny_cell("fb15k-transe_l2.train") for _ in range(2))
    from kgbench.generator import make_triples
    x = make_triples(a.config, a.traffic, SEED)
    y = make_triples(b.config, b.traffic, SEED)
    z = make_triples(b.config, b.traffic, SEED + 1)
    assert all((x[k][i] == y[k][i]).all() for k in x for i in range(3))
    assert any((x[k][i] != z[k][i]).any() for k in x for i in range(3))
    assert {k: len(v[0]) for k, v in x.items()} == {
        k: a.config[f"n_{k}"] for k in a.traffic["splits"]}


def test_negative_seed_runs():
    assert run_tiny("fb15k-transe_l2.train", seed=-7)["correct"]


def test_traced_run_reports_per_layer_metrics_it_can_read():
    out = run_tiny("fb15k-transe_l2.train", trace=True)
    assert out["correct"]
    # on the CPU there is no device trace and no device mark:
    # group_gap_pct.train finds nothing, and only the span reader reads
    assert set(out["metrics"]) == {"group_host_ms.train"}


def tiny_run(cell):
    r = Run(cell, SEED, "cpu", Spans(True))
    r.setup()
    return r


def test_program_window_puts_the_program_spans_in_ctx():
    cell = tiny_cell("fb15k-transe_l2.train")
    r = tiny_run(cell)
    r.window(0.1)
    harness = {k: len(v) for k, v in r.spans.seconds.items()}
    steps = r.feed.step_idx
    program = r.program_window()
    groups = cell.traffic["trace_groups"]
    assert r.ctx["program"] is program
    assert program["host"]["group"]["count"] == groups
    assert r.feed.step_idx - steps == groups * r.s
    # the harness's spans are off in this sub-window
    assert {k: len(v) for k, v in r.spans.seconds.items()} == harness
    # no card: no device mark, so the gap reader finds nothing
    assert "group" not in program["device"]
    reader = cell.readers["group_gap_pct.train"]
    assert reader.read(r.ctx) is None
    from dglke_tpu_torch import tracing
    assert tracing._on is None
    r.release()


def test_group_gap_reader_is_gaps_over_window():
    reader = tiny_cell("fb15k-rescal.train").readers["group_gap_pct.rescal"]
    ctx = {"program": {"device": {"group": {"gap_ms": 0.5,
                                            "window_ms": 200.0}}}}
    assert reader.read(ctx) == pytest.approx(0.25)


def test_transr_keeps_three_tables_and_three_states():
    r = tiny_run(tiny_transr_cell())
    conf = r.cell.config
    d = conf["flags"]["hidden_dim"]
    rows = [conf["n_entities"], conf["n_relations"], conf["n_relations"]]
    for k in r.marks:
        assert [tuple(w.shape) for w in r.snap[k]["w"]] == list(
            zip(rows, (d, d, d * d)))
        assert [tuple(s.shape) for s in r.snap[k]["s"]] == [
            (n,) for n in rows]
    # the projection moved over the first three steps, as the others did
    assert all(not torch.equal(a, b) for a, b in
               zip(r.snap[0]["w"], r.snap[3]["w"]))
    r.release()


@pytest.mark.parametrize("workload", TRAIN + ["transr"])
def test_reference_draws_the_port_tables(workload):
    """streams.init_tables, from the family's declared widths and ranges,
    draws bit for bit what the port's init_state draws."""
    cell = cell_of(workload)
    r = tiny_run(cell)
    family = load_module(PACKAGE / "reference" / f"{cell.family}.py")
    drawn = streams.init_tables(
        run_seed(SEED), streams.table_shapes(family, cell.config),
        torch.device("cpu"))
    assert len(drawn) == len(r.snap[0]["w"])
    assert all(torch.equal(a, b) for a, b in zip(drawn, r.snap[0]["w"]))
    r.release()


def test_reference_regularizes_entity_and_relation_rows_only():
    cell = tiny_transr_cell()
    family = load_module(PACKAGE / "reference" / "transr.py")
    flags = dict(cell.config["flags"])
    d, b = flags["hidden_dim"], flags["batch_size"]
    gen = torch.Generator().manual_seed(5)
    tables = [torch.rand(n, w, generator=gen) for n, w in
              ((50, d), (4, d), (4, d * d))]
    h, t, r = (torch.randint(0, n, (b,), generator=gen)
               for n in (50, 50, 4))
    neg = torch.randint(0, 50, (flags["neg_sample_size"] * 4,),
                        generator=gen)
    grads = {}
    for coef in (0.0, 1e-3):
        flags["regularization_coef"] = coef
        grads[coef] = train_steps.step_loss_and_grads(
            family, flags, tables, h, r, t, neg, True)[2]
    ent, rel, proj = (torch.equal(a, b) for a, b in zip(grads[0.0],
                                                        grads[1e-3]))
    assert not ent and not rel and proj
