"""The control of ``correct`` on a card: the reference computed with TF32
matrix products, put in the program's place, is not correct against the
reference in fp32 (the configurations' precision), at a size a test run
holds."""

import copy
import time

import numpy as np
import pytest
import torch

from kgbench import calibrate, check, run
from kgbench.spec import load_cell
from kgbench.tests.tiny import tiny_cell


def mid_cell(workload):
    """FB15k's tables at a tenth of its edges, RESCAL at hidden 100;
    wikikg2 at its own flags with a tenth of its entities and edges; held
    to the cell's own limits."""
    if workload.startswith("wikikg2"):
        cell = load_cell(workload)
        cell.config = copy.deepcopy(cell.config)
        cell.config.update(n_entities=250060, n_train=1610918)
        return cell
    cell = tiny_cell(workload)
    cell.limits = load_cell(workload).limits
    cell.config.update(n_entities=14951, n_relations=1345, n_train=60000)
    cell.config["flags"].update(
        hidden_dim=400 if cell.family == "transe_l2" else 100,
        batch_size=1000, neg_sample_size=200, log_interval=1000)
    return cell


@pytest.mark.card
@pytest.mark.parametrize("workload", ["fb15k-transe_l2.train",
                                      "fb15k-rescal.train",
                                      "wikikg2-transe_l2.train"])
def test_control_is_not_correct(card, workload):
    cell = mid_cell(workload)
    for seed in (11, 12, 13):
        got = calibrate.control(cell, seed, card)["numbers"]
        correct, _ = check.judge(got, cell.limits)
        assert not correct, got


@pytest.mark.card
def test_program_is_correct_on_the_card(card):
    cell = mid_cell("fb15k-transe_l2.train")
    out = run.run_cell(cell, 2 ** 33 + 5, 1.0, False, card,
                       time.perf_counter())
    assert out["correct"], out["checks"]
    assert np.isfinite(out["metrics"]["train_triples_per_s"]["value"])
    torch.cuda.empty_cache()
