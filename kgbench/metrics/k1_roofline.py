"""K1's share of its roofline over the traced training steps: the bound
of their counted bytes (kgbench/counts) over K1's summed device time."""

from kgbench.metrics._shared import roofline_pct


def read(ctx: dict):
    return roofline_pct(ctx, "k1")
