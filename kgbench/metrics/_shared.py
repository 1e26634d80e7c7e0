"""What several readers share: a kernel group's roofline share over the
traced window."""

from __future__ import annotations

from kgbench import peaks
from kgbench.trace import matching

KERNELS = {
    "k1": ("gather_rows_",),
    "k2": ("group_ids", "sort_tile", "merge_runs", "count_heads",
           "scan_heads", "place_heads", "segment_update_"),
    "k3": ("outer_heads", "outer_cluster", "outer_pass", "outer_reduce"),
}


def roofline_pct(ctx: dict, kernel: str):
    """The bound of the traced steps' bytes and operations of ``kernel``
    over its summed device seconds there, in %; None where it did not
    run or nothing was counted."""
    trace, counts = ctx.get("trace"), ctx.get("kernels", {})
    if trace is None or kernel not in counts:
        return None
    seconds = matching(trace.kernel_s, KERNELS[kernel])
    if not seconds:
        return None
    return 100.0 * peaks.bound_s(*counts[kernel]) / seconds
