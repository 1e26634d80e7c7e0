"""Operations and bytes of RESCAL (h . (R t), R a [hidden, hidden]
relation row) on the port's factored route: the relation update is K3's."""

from __future__ import annotations

from kgbench.counts import common


def widths(hidden: int) -> tuple:
    return hidden, hidden * hidden


def forward_flops(flags: dict) -> float:
    b, k, c = common.chunks_of(flags)
    d = flags["hidden_dim"]
    n_ent, n_rel = common.step_ids(flags)
    tmp = 2.0 * b * d * d                      # R t, or h^T R
    pos = 2.0 * b * d
    neg = 2.0 * b * k * d
    loss = 11.0 * b * k + 4.0 * b
    reg = 4.0 * n_ent * d + 4.0 * n_rel * d * d
    return tmp + pos + neg + loss + reg


def step_flops(flags: dict) -> float:
    """Forward, backward at twice the forward, Adagrad of the entity rows
    (K2) and of every occurrence's relation row (K3)."""
    n_ent, n_rel = common.step_ids(flags)
    d = flags["hidden_dim"]
    return (3.0 * forward_flops(flags)
            + common.k2_update_flops(n_ent, n_ent, d)
            + common.k3_flops(n_rel, n_rel, d * d))


def kernel_bytes(flags: dict, ent_distinct: int, rel_distinct: int) -> dict:
    n_ent, n_rel = common.step_ids(flags)
    d = flags["hidden_dim"]
    return {
        "k1": (common.k1_bytes(n_ent, ent_distinct, d)
               + common.k1_bytes(n_rel, rel_distinct, d * d), 0.0),
        "k2": (common.grouping_bytes(n_ent) + common.grouping_bytes(n_rel)
               + common.k2_update_bytes(n_ent, ent_distinct, d),
               common.k2_update_flops(n_ent, ent_distinct, d)),
        "k3": (common.k3_bytes(n_rel, rel_distinct, d * d, d),
               common.k3_flops(n_rel, rel_distinct, d * d)),
    }
