"""What a run may load, and where it refuses to measure."""

import ast
import shutil
import subprocess
import sys

import pytest

from kgbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "dglke_tpu"}


def imported_roots(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in spec.PACKAGE.rglob("*.py")
                 if "tests" not in p.relative_to(spec.PACKAGE).parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(spec.ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    assert not FORBIDDEN & set(imported_roots(path))


def test_reference_imports_nothing_of_the_program():
    for path in (spec.PACKAGE / "reference").glob("*.py"):
        roots = set(imported_roots(path))
        assert "dglke_tpu_torch" not in roots and not FORBIDDEN & roots


def test_forbidden_modules_compares_whole_top_level_names():
    mods = ["dglke_tpu_torch", "dglke_tpu_torch.ops", "jaxtyping",
            "numpy", "flax.linen", "dglke_tpu.trainer"]
    assert run.forbidden_modules(mods) == ["dglke_tpu", "flax"]
    assert run.forbidden_modules(["dglke_tpu_torch.trainer"]) == []


def test_a_run_without_a_card_fails(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "fb15k-transe_l2.train", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_a_traced_run_without_device_events_fails(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a: {
        "correct": True, "metrics": {}, "checks": {},
        "device": {"busy_s": 0.0, "window_s": 0.0}})
    rc = run.main(["--workload", "fb15k-transe_l2.train", "--seed", "1",
                   "--seconds", "1", "--trace", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no device event" in out.err


def test_the_benchmark_alone_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and kgbench/ (no
    program), the command exits non-zero and prints no result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.PACKAGE, tmp_path / "kgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "kgbench.run", "--workload",
         "fb15k-transe_l2.train", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
