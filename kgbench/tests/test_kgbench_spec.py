"""BENCHMARK.json against the contract's shape, and every file a cell names
found by its name."""

import json
import re

import pytest

from kgbench import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["kgbench"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        names.append(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names += WORKLOADS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]


def test_each_per_layer_metric_reports_its_moved_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in WORKLOADS
            assert "workloads" not in moved or w in moved["workloads"]


def test_configs_match_their_files():
    for c in BENCH["configs"]:
        conf = spec.load_json(spec.ROOT / c["file"])
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert c["file"].startswith("kgbench/configs/")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_loads_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.chips == 1
    assert set(cell.readers) == {m["name"] for m in cell.per_layer}
    assert all(hasattr(r, "read") for r in cell.readers.values())
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    counts = cell.counts()
    assert counts.step_flops(cell.config["flags"]) > 0
    assert (spec.PACKAGE / "reference" / f"{cell.family}.py").is_file()
    assert (spec.PACKAGE / "loops" / f"{cell.traffic['loop']}.py").is_file()
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_readers_find_nothing_in_an_empty_context(workload):
    cell = spec.load_cell(workload)
    for reader in cell.readers.values():
        assert reader.read({}) is None
