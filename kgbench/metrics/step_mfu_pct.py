"""The whole training step's share of fp32's peak: the step's operations
by the score family's count (forward, backward at twice the forward,
regularization and Adagrad; kgbench/counts) over the traced window's
seconds a step."""

from kgbench import peaks


def read(ctx: dict):
    trace, steps = ctx.get("trace"), ctx.get("steps")
    if trace is None or not steps:
        return None
    flops = ctx["counts"].step_flops(ctx["flags"]) * steps
    return 100.0 * flops / trace.window_s / peaks.FP32_FLOPS_PER_S
