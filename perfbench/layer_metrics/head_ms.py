"""head_ms: the subpixel head and the masked-reconstruction loss, forward
and backward, ms a step on the device clock (perfbench/spans.py)."""

from perfbench.spans import piece_ms


def read(ctx):
    return piece_ms(ctx, "head")
