"""Readings that set the limits of ``correct``, at a cell's own size.

    python3 -m kgbench.calibrate --workload <name> --seeds 1,2,... \
        [--control 3] [--fault half_batch ... --fault-seeds 3] [--out FILE]

For each seed: the program's numbers, as a run's check reads them after
set-up (no measured window: the check reads the first group call and the
third).  ``--control n``: on the first n seeds, the reference computed
with TF32 matrix products put in the program's place, against the
reference in full fp32 (the configuration's precision).  ``--fault``
(repeatable): a fault of ``kgbench/faults.py`` planted in the program, on
the first ``--fault-seeds`` seeds.  Each reading is judged against the
cell's limits as a run's would be.  One JSON line a reading, with its
``correct``, on standard output and appended to ``--out``.  Runs on a
CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from kgbench import check, faults
from kgbench.loops.common import port_config, quiet, to_host
from kgbench.reference import train_steps
from kgbench.run import forbidden_modules, set_caches
from kgbench.seeds import run_seed
from kgbench.spec import PACKAGE, load_cell, load_module
from kgbench.trace import Spans


@contextlib.contextmanager
def tf32(on: bool):
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _loop(cell):
    import importlib
    return importlib.import_module(f"kgbench.loops.{cell.traffic['loop']}")


def program(cell, seed: int, dev, fault=None) -> dict:
    plant = faults.FAULTS[fault]() if fault else contextlib.nullcontext()
    with plant:
        run = _loop(cell).Run(cell, seed, dev, Spans(False))
        run.setup()
        run.release()
    numbers = run.check()
    return {"numbers": numbers, "info": _info(run)}


def _info(run) -> dict:
    return {"program": run.prog_readings, "reference": run.ref_readings}


def control(cell, seed: int, dev) -> dict:
    """The reference with TF32 products in the program's place."""
    from kgbench.generator import make_triples
    run = _loop(cell).Run(cell, seed, dev, Spans(False))
    run.triples = make_triples(cell.config, cell.traffic, seed)["train"]
    run.s = _group_size(cell)
    run.marks = check.marks(run.s)
    family = load_module(PACKAGE / "reference" / f"{cell.family}.py")
    trip = torch.as_tensor(np.stack(run.triples), device=dev)
    with tf32(True):
        run.snap = train_steps.run(family, cell.config, trip,
                                   run_seed(seed), run.marks,
                                   to_host=to_host)
    del trip
    numbers = run.check()
    return {"numbers": numbers, "info": _info(run)}


def _group_size(cell) -> int:
    """s, as the program's trainer sets it for the cell's configuration."""
    from dglke_tpu_torch import trainer
    cfg = port_config(cell.config, 0)
    return trainer.steps_per_group(cfg, cell.config["n_train"], True,
                                   log=quiet)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--fault-seeds", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    set_caches()
    cell = load_cell(args.workload)
    cell.traffic["warm_seconds"] = 0.0
    dev = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    jobs = [("program", s) for s in seeds]
    jobs += [("control", s) for s in seeds[:args.control]]
    for fault in args.fault:
        jobs += [(fault, s) for s in seeds[:args.fault_seeds]]
    for kind, seed in jobs:
        if kind == "program":
            out = program(cell, seed, dev)
        elif kind == "control":
            out = control(cell, seed, dev)
        else:
            out = program(cell, seed, dev, fault=kind)
        correct, _ = check.judge(out["numbers"], cell.limits)
        line = json.dumps({"workload": args.workload, "kind": kind,
                           "seed": seed, "correct": correct, **out})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        print(f"loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
