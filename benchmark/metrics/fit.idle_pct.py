"""``fit.idle_pct``: the share of the traced fit's wall time in which no
operation ran on the device, in percent."""

from benchmark.harness.layers import idle_pct


def read(ctx):
    return idle_pct(ctx) if "shape" in ctx else None
