"""The share of the traced window in which no operation ran on the card
(the union of the device's operation intervals, from the trace)."""


def read(ctx: dict):
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
