"""Operations and bytes of TransE_l2 (gamma - ||h + r - t||_2)."""

from __future__ import annotations

from kgbench.counts import common


def widths(hidden: int) -> tuple:
    return hidden, hidden


def forward_flops(flags: dict) -> float:
    b, k, c = common.chunks_of(flags)
    d = flags["hidden_dim"]
    n_ent, n_rel = common.step_ids(flags)
    pos = 4.0 * b * d + b                      # h + r - t, square, sum, sqrt
    neg = (3.0 * b * d + 2.0 * c * k * d       # query, its and the negs' norms
           + 2.0 * b * k * d + 5.0 * b * k)    # cross term, combine, sqrt
    loss = 11.0 * b * k + 4.0 * b              # logsigmoid, softmax, sums
    reg = 4.0 * (n_ent + n_rel) * d            # |x|^3 and its sum
    return pos + neg + loss + reg


def step_flops(flags: dict) -> float:
    """One training step: forward, backward at twice the forward, and
    Adagrad over every gathered row (K2's count)."""
    n_ent, n_rel = common.step_ids(flags)
    d = flags["hidden_dim"]
    return (3.0 * forward_flops(flags)
            + common.k2_update_flops(n_ent, n_ent, d)
            + common.k2_update_flops(n_rel, n_rel, d))


def kernel_bytes(flags: dict, ent_distinct: int, rel_distinct: int) -> dict:
    """{kernel: (bytes, operations)} of one step."""
    n_ent, n_rel = common.step_ids(flags)
    d = flags["hidden_dim"]
    return {
        "k1": (common.k1_bytes(n_ent, ent_distinct, d)
               + common.k1_bytes(n_rel, rel_distinct, d), 0.0),
        "k2": (common.grouping_bytes(n_ent) + common.grouping_bytes(n_rel)
               + common.k2_update_bytes(n_ent, ent_distinct, d)
               + common.k2_update_bytes(n_rel, rel_distinct, d),
               common.k2_update_flops(n_ent, ent_distinct, d)
               + common.k2_update_flops(n_rel, rel_distinct, d)),
    }
