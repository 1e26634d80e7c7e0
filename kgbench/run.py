"""Run one cell of the benchmark once and print its result line.

    python3 -m kgbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Exits non-zero without a result where no CUDA card (or fewer than the
cell asks for) is present, where a traced run's profile holds no device
event, and where the process has loaded JAX or the JAX package by the
end.  The last line of standard output is the result;
the last lines of standard error are the numbers that decided
``correct``, each beside its limit.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """perf_counter's reading at this process's start (Linux /proc), or
    now where /proc does not say."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or torch may build lives at a fixed path inside
# the checkout, so that only a cell's first run there builds
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "nv"}
FORBIDDEN = ("jax", "jaxlib", "flax", "dglke_tpu")


def set_caches(root: Path = ROOT) -> None:
    for var, sub in CACHES.items():
        os.environ[var] = str(root / "build" / "kgbench" / sub)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of ``cell`` on ``device``: set-up, the window, with
    ``trace`` an unprofiled sub-window with the program's spans on and
    then a profiled one, then the check.  Returns the result's fields,
    ``checks`` last."""
    import importlib

    import torch

    from kgbench import check
    from kgbench.trace import Spans, breakdown
    loop = importlib.import_module(f"kgbench.loops.{cell.traffic['loop']}")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run = loop.Run(cell, seed, dev, Spans(trace))
    run.setup()
    setup_s = time.perf_counter() - t_start
    measured = run.window(seconds)
    summary = None
    if trace:
        run.program_window()
        summary = run.traced()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        kind = torch.cuda.get_device_name(dev)
    else:
        peak, kind = 0, "cpu"
    run.release()
    numbers = run.check()
    correct, rows = check.judge(numbers, cell.limits)
    device_out = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                  "kind": kind, "count": cell.chips,
                  "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": measured["attempted"],
              "failed": measured["failed"]}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(run.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_out["busy_s"] = summary.busy_s if summary else 0.0
        device_out["window_s"] = summary.window_s if summary else 0.0
        result.update(metrics=metrics, device=device_out)
        if summary:
            result["breakdown"] = breakdown(summary)
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in cell.end_to_end:
            # a loop measures a quantity; the cell's metric of it may
            # carry a suffix (train_triples_per_s.rescal)
            quantity = m["name"].split(".")[0]
            if quantity in measured:
                metrics[m["name"]] = {"value": measured[quantity],
                                      "unit": m["unit"]}
        result.update(metrics=metrics, device=device_out)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_caches()
    from kgbench.spec import load_cell
    cell = load_cell(args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"kgbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {found}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    if args.trace and "breakdown" not in result:
        print("kgbench: the profiled sub-window's trace held no device "
              "event", file=sys.stderr)
        return 4
    loaded = forbidden_modules()
    if loaded:
        print(f"kgbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
