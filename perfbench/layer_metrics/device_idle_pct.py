"""device_idle_pct: the share of the profiled stretch, from its start, in which no
operation ran on the device."""

from perfbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
