"""dglke_tpu_torch-dist_train: ip_config parsing, the command each rank
gets (torch's launcher variables in place of the JAX package's), and
fail-fast termination (ssh replaced by a stub through a monkeypatched
Popen); the counterpart of tests/test_dist_launcher.py."""

import subprocess
import sys

from dglke_tpu.cli import dist_train as jax_dist_train
from dglke_tpu_torch.cli import dist_train


def test_read_ip_config_matches_the_jax_launcher(tmp_path):
    p = tmp_path / "ip_config.txt"
    p.write_text("10.0.0.1 30050 8\n10.0.0.2\n\n10.0.0.3 40000\n")
    hosts = dist_train.read_ip_config(str(p))
    assert hosts == [("10.0.0.1", 30050), ("10.0.0.2", 2379),
                     ("10.0.0.3", 40000)]
    assert hosts == jax_dist_train.read_ip_config(str(p))


def test_construct_cmd():
    class A:
        path = "/work"
        num_hosts = 3
        train_args = ["--model_name", "TransE_l2", "--dataset", "FB15k"]
    cmd = dist_train.construct_cmd(A(), 2, ("10.0.0.1", 30050))
    for var in ("MASTER_ADDR=10.0.0.1", "MASTER_PORT=30050", "RANK=2",
                "WORLD_SIZE=3", "LOCAL_RANK=0", "LOCAL_WORLD_SIZE=1"):
        assert var in cmd, (var, cmd)
    assert "JAX_" not in cmd
    assert "-m dglke_tpu_torch.cli.train --dist" in cmd
    assert "--model_name TransE_l2" in cmd


def test_lines_of_one_machine_are_its_local_ranks():
    hosts = [("a", 1), ("b", 1), ("a", 1), ("a", 1)]
    assert dist_train.rank_layout(hosts) == [(0, 3), (0, 1), (1, 3), (2, 3)]


def test_failure_propagates_and_terminates(tmp_path, monkeypatch):
    p = tmp_path / "ip_config.txt"
    p.write_text("h0\nh1\n")
    calls, procs = [], []
    real_popen = subprocess.Popen

    def fake_popen(cmd, *a, **kw):
        # rank order: the first sleeps for ever, the second fails at once
        rank = len(calls)
        calls.append(cmd)
        code = ("import time; time.sleep(60)" if rank == 0
                else "raise SystemExit(3)")
        procs.append(real_popen([sys.executable, "-c", code]))
        return procs[-1]

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    rc = dist_train.main(["--path", "/work", "--ip_config", str(p),
                          "--", "--dataset", "FB15k"])
    assert rc == 3
    assert len(calls) == 2
    # the survivor was terminated, not left running
    assert procs[0].returncode is not None and procs[0].returncode != 0
    assert "RANK=1 WORLD_SIZE=2" in calls[1][-1]


def test_forwarding_without_separator(tmp_path, monkeypatch):
    """Flags forward with or without '--', quoted for the remote shell."""
    p = tmp_path / "ip_config.txt"
    p.write_text("h0\n")
    cmds = []
    real_popen = subprocess.Popen

    def fake_popen(cmd, *a, **kw):
        cmds.append(cmd)
        return real_popen([sys.executable, "-c", "pass"])

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    rc = dist_train.main(["--path", "/w w", "--ip_config", str(p),
                          "--model_name", "TransE_l2",
                          "--delimiter", "\t"])
    assert rc == 0
    remote = cmds[0][-1]
    assert "--model_name TransE_l2" in remote
    assert "'/w w'" in remote            # a path with a space is quoted
    assert "'\t'" in remote              # a tab delimiter survives quoting
    assert " -- " not in remote          # no stray separator forwarded

    cmds.clear()
    rc = dist_train.main(["--path", "/w", "--ip_config", str(p), "--",
                          "--dataset", "FB15k"])
    assert rc == 0
    assert "-- --dataset" not in cmds[0][-1]
    assert "--dataset FB15k" in cmds[0][-1]


def test_all_ranks_succeeding_returns_zero():
    procs = [subprocess.Popen([sys.executable, "-c", "pass"])
             for _ in range(3)]
    assert dist_train.wait_fail_fast(procs, poll_s=0.05) == 0
    assert all(p.returncode == 0 for p in procs)
