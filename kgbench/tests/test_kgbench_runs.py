"""Whole runs on the CPU at a tiny size (the plain PyTorch paths of the
port): the reference agrees with the port, and a fault planted under the
timed path turns ``correct`` false.  The look for a card is skipped by
calling ``run_cell`` directly."""

import time

import pytest

from kgbench import faults, run
from kgbench.tests.tiny import tiny_cell

SEED = 3 ** 40   # larger than 32 bits hold
TRAIN = ["fb15k-transe_l2.train", "fb15k-rescal.train"]


def run_tiny(workload, seed=SEED, trace=False):
    return run.run_cell(tiny_cell(workload), seed, 0.3, trace, "cpu",
                        time.perf_counter())


@pytest.mark.parametrize("workload", TRAIN)
def test_sound_run_is_correct(workload):
    out = run_tiny(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    names = {m["name"] for m in tiny_cell(workload).end_to_end}
    assert set(out["metrics"]) == names


@pytest.mark.parametrize("workload", TRAIN)
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
    # on the CPU there is no device trace: only the span reader reads
    assert set(out["metrics"]) == {"group_host_ms.train"}
