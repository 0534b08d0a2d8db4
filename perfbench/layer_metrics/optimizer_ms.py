"""optimizer_ms: the train step's update (the span nerf_mae.optimizer: the
zero-fill of missing gradients, the clip and AdamW), ms a step on the
device clock (perfbench/spans.py)."""

from perfbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "nerf_mae.optimizer")
