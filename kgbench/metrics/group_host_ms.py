"""Host milliseconds of one group call (the pipeline's begin_group, the
replay, end_group), the mean over the window's group calls, from the
harness's span around each call."""

import statistics


def read(ctx: dict):
    ms = ctx.get("group_ms")
    return statistics.fmean(ms) if ms else None
