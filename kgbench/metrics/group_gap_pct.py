"""The share of the program's sub-window in which the card waited for the
host between two group calls: the summed device gaps between the
``group`` span's device marks over their window (first entry to last
exit), in %, from the port's own spans (``ctx["program"]``), unprofiled.
None where the spans hold no device-marked group (the CPU)."""


def read(ctx: dict):
    group = (ctx.get("program") or {}).get("device", {}).get("group")
    if not group or group["window_ms"] <= 0:
        return None
    return 100.0 * group["gap_ms"] / group["window_ms"]
