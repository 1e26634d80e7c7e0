"""Shared by the --dist tests of dglke_tpu_torch: start n rank processes
of a worker script on the CPU (gloo, a free localhost port, torch's
launcher variables), each with a timeout, and collect what each printed.
A worker prints its result as one JSON line starting with ``RESULT``."""

import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int, path=()) -> dict:
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([ROOT, *path]))
    env.pop("XLA_FLAGS", None)
    return env


def start_ranks(argv_of, world: int = 2, cwd: str = ROOT, path=()):
    """Start ``world`` processes, rank r running ``argv_of(r)`` (a list
    after the Python executable; ``path``: more import directories);
    returns them, for wait_ranks."""
    port = free_port()
    return [subprocess.Popen([sys.executable, *argv_of(r)], cwd=cwd,
                             env=rank_env(r, world, port, path),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for r in range(world)]


def wait_ranks(procs, timeout: float = 240.0):
    """Each rank's (exit code, stdout, stderr).  A rank that outlives the
    timeout is killed, and so are the rest."""
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            out.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def run_ranks(argv_of, world: int = 2, timeout: float = 240.0,
              cwd: str = ROOT):
    """start_ranks, then wait_ranks."""
    return wait_ranks(start_ranks(argv_of, world, cwd), timeout)


def results(outputs) -> list:
    """The RESULT json of each rank; fails with the rank's output when a
    rank failed."""
    res = []
    for rank, (rc, so, se) in enumerate(outputs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{so[-3000:]}\n{se[-3000:]}"
        lines = [ln for ln in so.splitlines() if ln.startswith("RESULT ")]
        assert len(lines) == 1, so[-3000:]
        res.append(json.loads(lines[0][len("RESULT "):]))
    return res


def cli_argv(module: str, args):
    """The argv of ``python -m module --dist --device cpu *args``."""
    return lambda r: ["-m", module, "--dist", "--device", "cpu", *args]


def cli_ranks(module: str, args, world: int = 2, timeout: float = 240.0):
    """``python -m module --dist --device cpu *args`` on ``world`` ranks;
    returns each rank's (exit code, stdout, stderr)."""
    return run_ranks(cli_argv(module, args), world, timeout)
