"""Operations and bytes of TransR (gamma - ||h M_r + r - t M_r||_1, M_r a
[hidden, hidden] row of the projection table): a third table gathered by
K1 and updated by K2 (its block route: 40,000-element rows at hidden
200), and every negative projected by every relation of its chunk."""

from __future__ import annotations

from kgbench.counts import common


def forward_flops(flags: dict) -> float:
    b, k, c = common.chunks_of(flags)
    d = flags["hidden_dim"]
    n_ent, n_rel = common.step_ids(flags)
    project = 2.0 * 2.0 * b * d * d            # h M_r and t M_r
    neg_project = 2.0 * b * k * d * d          # each negative by each M_r
    pos = 4.0 * b * d                          # + r, - t M_r, abs, sum
    neg = b * d + 3.0 * b * k * d + b * k      # s + r; diff, abs, sum; -
    loss = 11.0 * b * k + 4.0 * b              # logsigmoid, softmax, sums
    reg = 4.0 * (n_ent + n_rel) * d            # entity and relation rows
    return project + neg_project + pos + neg + loss + reg


def step_flops(flags: dict) -> float:
    """Forward, backward at twice the forward, Adagrad over every gathered
    entity, relation and projection row (K2's count)."""
    n_ent, n_rel = common.step_ids(flags)
    d = flags["hidden_dim"]
    return (3.0 * forward_flops(flags)
            + common.k2_update_flops(n_ent, n_ent, d)
            + common.k2_update_flops(n_rel, n_rel, d)
            + common.k2_update_flops(n_rel, n_rel, d * d))


def kernel_bytes(flags: dict, ent_distinct: int, rel_distinct: int) -> dict:
    """{kernel: (bytes, operations)} of one step: three gathers, and three
    groupings each with its update."""
    n_ent, n_rel = common.step_ids(flags)
    d = flags["hidden_dim"]
    rel_tables = (d, d * d)                    # relation, projection
    return {
        "k1": (common.k1_bytes(n_ent, ent_distinct, d)
               + sum(common.k1_bytes(n_rel, rel_distinct, w)
                     for w in rel_tables), 0.0),
        "k2": (common.grouping_bytes(n_ent)
               + common.k2_update_bytes(n_ent, ent_distinct, d)
               + sum(common.grouping_bytes(n_rel)
                     + common.k2_update_bytes(n_rel, rel_distinct, w)
                     for w in rel_tables),
               common.k2_update_flops(n_ent, ent_distinct, d)
               + sum(common.k2_update_flops(n_rel, rel_distinct, w)
                     for w in rel_tables)),
    }
