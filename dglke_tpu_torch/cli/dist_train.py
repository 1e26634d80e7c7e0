"""`dglke_tpu_torch-dist_train`: start dglke_tpu_torch-train --dist on every
machine of an ip_config over ssh (counterpart of dglke_tpu/cli/dist_train.py).

  1. reads ``ip_config.txt`` ("ip [port] [count]" lines, the reference's
     format): one rank a line, the first line's ip and port the rendezvous
     (MASTER_ADDR / MASTER_PORT); lines that repeat an ip are further
     ranks of that machine (LOCAL_RANK counts them, LOCAL_WORLD_SIZE is
     their number, so that each takes its own card);
  2. copies nothing: the repo is expected at --path on every machine;
  3. ssh-starts ``python -m dglke_tpu_torch.cli.train --dist ...`` with
     torch's launcher variables (MASTER_ADDR, MASTER_PORT, RANK,
     WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE);
  4. waits, and on the first rank that fails terminates the others (a dead
     rank wedges the rest in a collective).

On one machine ``torchrun --nproc_per_node N -m dglke_tpu_torch.cli.train
--dist ...`` sets the same variables.
"""

from __future__ import annotations

import argparse
import shlex
import subprocess
import sys
import time
from typing import List, Tuple


def read_ip_config(path: str) -> List[Tuple[str, int]]:
    """Lines "ip [port] [server_count]": (ip, port), port 2379 when
    absent."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            out.append((parts[0], int(parts[1]) if len(parts) > 1 else 2379))
    return out


def rank_layout(hosts: List[Tuple[str, int]]) -> List[Tuple[int, int]]:
    """(LOCAL_RANK, LOCAL_WORLD_SIZE) of each line's rank: its index among
    the lines with its ip, and their number."""
    ips = [ip for ip, _ in hosts]
    return [(ips[:i].count(ip), ips.count(ip)) for i, ip in enumerate(ips)]


def construct_cmd(args, rank: int, master: Tuple[str, int],
                  local_rank: int = 0, local_world: int = 1) -> str:
    passthrough = list(args.train_args or [])
    if passthrough and passthrough[0] == "--":
        passthrough = passthrough[1:]  # a '--' separator must not reach
        # the remote train parser (it rejects positional tokens)
    quoted = " ".join(shlex.quote(a) for a in passthrough)
    return (f"cd {shlex.quote(args.path)} && "
            f"MASTER_ADDR={master[0]} MASTER_PORT={master[1]} "
            f"RANK={rank} WORLD_SIZE={args.num_hosts} "
            f"LOCAL_RANK={local_rank} LOCAL_WORLD_SIZE={local_world} "
            f"{sys.executable} -m dglke_tpu_torch.cli.train --dist "
            + quoted)


def wait_fail_fast(procs, poll_s: float = 0.5) -> int:
    """Wait for every rank; on the first non-zero exit terminate the rest.
    Returns 0, or the first failing rank's exit code.  Every rank still
    running is terminated and reaped on the way out, Ctrl-C included."""
    rc = 0
    live = dict(enumerate(procs))
    try:
        while live and rc == 0:
            for rank, proc in list(live.items()):
                code = proc.poll()
                if code is None:
                    continue
                del live[rank]
                if code != 0:
                    print(f"rank {rank} failed with exit code {code}; "
                          f"terminating remaining ranks", file=sys.stderr)
                    rc = code
            if rc == 0 and live:
                time.sleep(poll_s)
    finally:
        for proc in live.values():
            proc.terminate()
        for proc in live.values():
            proc.wait()
    return rc


def main(argv=None):
    p = argparse.ArgumentParser("dglke_tpu_torch-dist_train")
    p.add_argument("--path", type=str, required=True,
                   help="workspace path on every machine")
    p.add_argument("--ip_config", type=str, required=True)
    p.add_argument("--ssh_key", type=str, default=None)
    p.add_argument("--user", type=str, default=None)
    # everything not recognized here goes to dglke_tpu_torch-train on every
    # machine ('--' separator optional)
    args, extra = p.parse_known_args(argv)
    args.train_args = extra

    hosts = read_ip_config(args.ip_config)
    args.num_hosts = len(hosts)
    procs = []
    for rank, ((ip, _), (local_rank, local_world)) in enumerate(
            zip(hosts, rank_layout(hosts))):
        cmd = construct_cmd(args, rank, hosts[0], local_rank, local_world)
        # -tt: a pty, so that terminating the local ssh client ends the
        # remote rank too
        ssh = ["ssh", "-tt", "-o", "StrictHostKeyChecking=no"]
        if args.ssh_key:
            ssh += ["-i", args.ssh_key]
        target = f"{args.user}@{ip}" if args.user else ip
        procs.append(subprocess.Popen(ssh + [target, cmd]))
        print(f"launched rank {rank} on {ip}")
    return wait_fail_fast(procs)


if __name__ == "__main__":
    raise SystemExit(main())
