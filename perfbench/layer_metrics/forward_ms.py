"""forward_ms: the train step's forward and loss (the span nerf_mae.forward),
ms a step on the device clock (perfbench/spans.py)."""

from perfbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "nerf_mae.forward")
