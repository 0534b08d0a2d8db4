"""optimizer_idle_ms: optimizer_ms less the device time launched under the
span's profiler range: the device waiting while the host launches the
clip and AdamW, ms a step (perfbench/spans.py)."""

from perfbench.spans import range_idle_ms


def read(ctx):
    return range_idle_ms(ctx, "nerf_mae.optimizer")
