"""backward_ms: the train step's backward (the span nerf_mae.backward around
loss.backward()), ms a step on the device clock (perfbench/spans.py)."""

from perfbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "nerf_mae.backward")
