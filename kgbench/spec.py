"""The cell a run measures, assembled from files found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; each
of these, and each per-layer metric, count and reference, is a file of its
own under ``kgbench/``:

- ``configs/<config>.json``: sizes, the port's flags, ``reduced`` and
  ``assumed``, and the score ``family``;
- ``traffic/<traffic>.json``: the generator's parameters and the loop the
  window runs (``loop``);
- ``limits/<workload>.json``: the limit of each number that decides
  ``correct``;
- ``counts/<family>.py``: operations and bytes from the shapes;
- ``metrics/<metric>.py``: a per-layer metric's reader, or
  ``metrics/<quantity>.py``, the reader of every metric named
  ``<quantity>.<suffix>`` that has no file of its own;
- ``reference/<family>.py``: the family's tables and plain scoring.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str | None = None):
    """The Python file at ``path`` as a module (file names may hold dots,
    as metric names do)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        name or f"kgbench_file_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One cell: its ``BENCHMARK.json`` entry with every file it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list            # the cell's end-to-end metric entries
    per_layer: list             # the cell's per-layer metric entries
    readers: dict = field(default_factory=dict)   # metric name -> module

    @property
    def family(self) -> str:
        return self.config["family"]

    def counts(self):
        return load_module(PACKAGE / "counts" / f"{self.family}.py")


def _cell_metrics(entries: list, workload: str) -> list:
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def load_cell(workload: str, benchmark: Path | None = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` (at the checkout's root
    unless given) with its configuration, traffic, limits and readers."""
    bench = load_json(benchmark or ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {workload!r}")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cell = Cell(
        name=workload, chips=int(entry["chips"]),
        config=load_json(ROOT / config["file"]),
        traffic=load_json(PACKAGE / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(PACKAGE / "limits" / f"{workload}.json"),
        end_to_end=_cell_metrics(bench["end_to_end"], workload),
        per_layer=_cell_metrics(bench["per_layer"], workload))
    cell.readers = {m["name"]: load_module(reader_file(m["name"]))
                    for m in cell.per_layer}
    return cell


def reader_file(metric: str) -> Path:
    """``metrics/<metric>.py``, or else the reader of its quantity (the
    name before its first dot)."""
    own = PACKAGE / "metrics" / f"{metric}.py"
    return own if own.is_file() else (
        PACKAGE / "metrics" / f"{metric.split('.')[0]}.py")
