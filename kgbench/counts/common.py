"""Bytes and operations of the port's three kernels a training step, by
the rule of the kernel table in ``PERF.md``: each input read once and each
output written once, whatever a kernel reads again; rows read from a
table count once per distinct id.  fp32 rows and states (4 bytes),
int32 ids, int64 orders.

K1 (``gather_rows_*``) gathers the entity rows of [h | t | negatives]
and the relation rows.  K2 is the grouping (``group_ids``, or its tiles
route) and the segment update (``segment_update_*``): ids in, sorted ids
and order out; then sorted ids, order and gradients in, each distinct
row and its Adagrad state read and written.  Every grouping a step
launches counts here, K3's (RESCAL's relation ids) too.  K3
(``outer_*``) reads each distinct relation row and state and writes them,
and reads the two [B, hidden] factors and the grouping's outputs.
"""

from __future__ import annotations

F32, I32, I64 = 4, 4, 8


def k1_bytes(n_ids: int, distinct: int, width: int) -> float:
    return distinct * width * F32 + n_ids * width * F32 + n_ids * I32


def grouping_bytes(n_ids: int) -> float:
    return n_ids * I32 + n_ids * (I32 + I64)


def k2_update_bytes(n_ids: int, distinct: int, width: int) -> float:
    return (n_ids * (I32 + I64) + n_ids * width * F32
            + 2 * distinct * (width * F32 + F32))


def k2_update_flops(n_ids: int, distinct: int, width: int) -> float:
    # per gradient element: square and sum into the state, add into the
    # row's sum; per distinct element: divide, scale, add
    return 3.0 * n_ids * width + 3.0 * distinct * width


def k3_bytes(n_ids: int, distinct: int, width: int, hidden: int) -> float:
    return (n_ids * (I32 + I64) + 2 * n_ids * hidden * F32
            + 2 * distinct * (width * F32 + F32))


def k3_flops(n_ids: int, distinct: int, width: int) -> float:
    # per occurrence element: the outer product, the regularizer's
    # gradient (abs, two products), the square and the two sums; per
    # distinct element: divide, scale, add
    return 7.0 * n_ids * width + 3.0 * distinct * width


def step_ids(flags: dict) -> tuple:
    """(entity ids, relation ids) a step gathers."""
    b = flags["batch_size"]
    k = flags["neg_sample_size"]
    chunks = max(1, b // min(k, b))
    return 2 * b + chunks * k, b


def chunks_of(flags: dict) -> tuple:
    """(batch, negatives a chunk, chunks)."""
    b = flags["batch_size"]
    k = flags["neg_sample_size"]
    return b, k, max(1, b // min(k, b))
