"""How a run's ``--seed`` becomes the seeds of its data, tables and
streams (shared by the harness and the reference, which derive them
independently from the same rule)."""

from __future__ import annotations

# --seed is any whole number; generators take one below 2**63
MOD = 1 << 63


def run_seed(seed: int) -> int:
    """The seed the program is configured with, and the seed of the
    generator its tables are drawn from."""
    return int(seed) % MOD
